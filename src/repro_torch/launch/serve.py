"""Serving entry point: teacher-forced prefill through decode, then greedy generation.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \
        --batch 4 --prompt-len 12 --gen 20

Runs on one CUDA device unless ``--device cpu`` is given; if CUDA is asked
for and absent it raises rather than running on the CPU.  Port of
``repro.launch.serve`` on a 1x1 mesh: ``--mesh`` other than 1x1,
``--context-shard`` and ``--plane-report`` are refused.  A VLM (paligemma-3b)
decodes text only from an empty cache, as there; an encoder-decoder
(seamless-m4t-medium) is refused, because this driver has no frames to
encode and passes no cross state (the reference's crashes on it).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.models import transformer as tf
from repro_torch.serve.step import ServeSetup, init_serve_state, make_decode_step


def parse_mesh(s: str) -> tuple:
    return tuple(int(x) for x in s.lower().split("x"))


def resolve_device(name: str) -> torch.device:
    """The device asked for; CUDA that is absent raises, never falls back."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} asked for but torch.cuda.is_available() is "
                           "False; pass --device cpu to run the plain versions on the CPU")
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--context-shard", action="store_true")
    ap.add_argument("--plane-report", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if parse_mesh(args.mesh) != (1, 1):
        ap.error(f"--mesh {args.mesh}: only a 1x1 mesh (one device) is ported; rail-sharded "
                 "serving waits for ROADMAP.md, Queue 1: fabric and rail-sharded serving")
    if args.context_shard:
        ap.error("--context-shard is not ported; it waits for ROADMAP.md, Queue 1: fabric "
                 "and rail-sharded serving")
    if args.plane_report:
        ap.error("--plane-report needs the photonic control plane, which is not ported; it "
                 "waits for ROADMAP.md, Queue 1: control plane and simulator")
    if args.prompt_len < 1 or args.gen < 1:
        ap.error("--prompt-len and --gen must be at least 1")
    device = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.encoder is not None:
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder: its decode needs the cross state "
            f"(tf.init_cross_state of encoded frames), which this driver, like the JAX "
            f"package's, neither makes nor passes; drive serve.step.make_decode_step with "
            f"cross=tf.init_cross_state(params, tf.encode(params, frames, cfg), cfg)")
    params = tf.init_lm(cfg, seed=0, device=device)
    cap = args.prompt_len + args.gen
    setup = ServeSetup(cfg=cfg)
    state = init_serve_state(setup, (1, 1), params, args.batch, cap)
    decode = make_decode_step(setup, (1, 1), params, batch=args.batch, capacity=cap)
    gen = torch.Generator(device=device).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)

    _sync(device)
    t0 = time.perf_counter()
    # teacher-forced prefill through the decode path (cache build)
    for t in range(args.prompt_len):
        logits, state = decode(params, state, prompts[:, t:t + 1], t)
    out = []
    tok = logits[:, -1:].argmax(-1)
    for t in range(args.prompt_len, cap):
        logits, state = decode(params, state, tok, t)
        tok = logits[:, -1:].argmax(-1)
        out.append(tok)
    _sync(device)
    dt = time.perf_counter() - t0
    toks = args.batch * cap
    print(f"served {args.batch} seqs x {cap} steps in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s aggregate) on {device}")
    sample = [int(x[0, 0]) for x in out[:10]]
    print("sample continuation:", sample)
    return {"seconds": dt, "tokens": toks, "continuation": torch.cat(out, 1).cpu(),
            "logits": logits}


if __name__ == "__main__":
    main()
