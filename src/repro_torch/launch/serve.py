"""Serving entry point: teacher-forced prefill through decode, then greedy
generation, over FSDP-sharded parameters on the photonic rails (or EPS).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \
        --batch 4 --prompt-len 12 --gen 20
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.serve \
        --arch yi_9b --smoke --device cpu --mesh 4x2 --batch 8 [--context-shard]

Port of ``repro.launch.serve``.  ``--mesh`` is DxM or PxDxM (pod, data,
model), its product the world size: under ``torchrun`` it joins that group,
otherwise it forms a group of one process (``launch.train.init_distributed``)
and always serves through a ``DeviceMesh``.  The batch is sharded over the
rails, or with ``--context-shard`` every attention cache along its slots;
``--fabric`` picks the photonic rings or the native collectives (eps).
Rank 0 prints.  Runs on CUDA (NCCL) unless ``--device cpu`` is given
(gloo); if CUDA is asked for and absent it raises rather than running on
the CPU.  ``--plane-report`` replays the job through the control plane after
serving, with the decode capacity as the sequence length: the train
driver's ``plane_report`` (serve/train parity, as there).  A VLM
(paligemma-3b) decodes text only from an empty cache, as there; an encoder-decoder (seamless-m4t-medium) is refused,
because this driver has no frames to encode and passes no cross state (the
reference's crashes on it).
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config
from repro_torch.models import transformer as tf
from repro_torch.serve.step import (ServeSetup, init_serve_params, init_serve_state,
                                    make_decode_step)


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
    from repro_torch.launch.train import (add_plane_flags, init_distributed, make_mesh,
                                          parse_mesh, plane_report)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--fabric", default="photonic", choices=["photonic", "eps"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--context-shard", action="store_true")
    ap.add_argument("--device", default="cuda")
    add_plane_flags(ap)
    args = ap.parse_args(argv)

    if args.prompt_len < 1 or args.gen < 1:
        ap.error("--prompt-len and --gen must be at least 1")
    try:
        axes = parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    device = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.encoder is not None:
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder: its decode needs the cross state "
            f"(tf.init_cross_state of encoded frames), which this driver, like the JAX "
            f"package's, neither makes nor passes; drive serve.step.make_decode_step with "
            f"cross=tf.init_cross_state(params, tf.encode(params, frames, cfg), cfg)")
    formed = not dist.is_initialized()
    init_distributed(device)
    try:
        mesh = make_mesh(axes, device)
        out = _serve(args, cfg, mesh, device)
        if args.plane_report:
            out["plane"] = plane_report(cfg, mesh, args.batch, args.prompt_len + args.gen,
                                        args.ocs_latency)
        return out
    finally:
        if formed:  # a group of one formed here: gone with the run
            dist.destroy_process_group()


def _serve(args, cfg, mesh, device: torch.device) -> dict:
    rank0 = dist.get_rank() == 0
    setup = ServeSetup(cfg=cfg, fabric=args.fabric, context_shard=args.context_shard)
    params = init_serve_params(setup, mesh, seed=0, device=device)
    cap = args.prompt_len + args.gen
    state = init_serve_state(setup, mesh, params, args.batch, cap)
    decode = make_decode_step(setup, mesh, tf.init_lm(cfg, device="meta"), batch=args.batch,
                              capacity=cap)

    def whole(x):  # this rank's rows -> the global batch's (rails' management traffic)
        return x if args.context_shard else decode.fabric.all_gather(x, 0)
    gen = torch.Generator(device=device).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)

    _sync(device)
    t0 = time.perf_counter()
    # teacher-forced prefill through the decode path (cache build)
    for t in range(args.prompt_len):
        logits, state = decode(params, state, prompts[:, t:t + 1], t)
    out = []
    tok = whole(logits[:, -1:].argmax(-1))
    for t in range(args.prompt_len, cap):
        logits, state = decode(params, state, tok, t)
        tok = whole(logits[:, -1:].argmax(-1))
        out.append(tok)
    _sync(device)
    dt = time.perf_counter() - t0
    toks = args.batch * cap
    if rank0:
        print(f"served {args.batch} seqs x {cap} steps in {dt:.2f}s "
              f"({toks / dt:.1f} tok/s aggregate) on {device}, mesh {args.mesh}"
              f"{' (context-sharded)' if args.context_shard else ''}")
        print("sample continuation:", [int(x[0, 0]) for x in out[:10]])
    return {"seconds": dt, "tokens": toks, "continuation": torch.cat(out, 1).cpu(),
            "logits": whole(logits)}


if __name__ == "__main__":
    main()
