#!/usr/bin/env python3
"""h2o-danube-3-4b training steps on one card under each remat policy.

    python3 scripts/remat_ab.py [--rounds 2] [--steps 4]

Run from the root of the repository on a machine with an NVIDIA GPU and
nvcc.  At full width and depth, B=1, S=4096, on an NCCL group of one, each
round takes ``--steps`` AdamW steps from seed 0 under remat "none", "full"
and "dots", in an order that turns round by round, and prints for each: the
host-clock ms of every step (the median of all but the first), the device
ms of one step (torch.profiler's kernel time), the host-clock ms of
enqueueing one step's forward and backward (``grads_fn``, which returns
before the card finishes), and the peak memory.  Starts with the card's
``nvidia-smi`` name and power limit (``chip_smoke.phase_device``); exits 2
without a card.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def one(remat: str, steps: int, mesh, dev, cs) -> str:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.train.data import DataConfig, synth_batch
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import TrainSetup, init_sharded_state, make_train_step
    cfg = get_config("h2o_danube_3_4b").replace(remat=remat)
    setup = TrainSetup(cfg=cfg, opt=OptConfig(lr=3e-4, warmup_steps=1))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, opt, ef = init_sharded_state(setup, mesh, seed=0, device=dev)
    step = make_train_step(setup, mesh, tf.init_lm(cfg, device="meta"))
    batch = synth_batch(cfg, DataConfig(seq_len=4096, global_batch=1), 0, device=dev)
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, ef, _ = step(params, opt, ef, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    dev_ms = cs.device_ms(lambda: step(params, opt, ef, batch), 1)
    t0 = time.perf_counter()
    grads, _ = step.grads_fn(params, batch)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    del grads
    return (f"remat {remat}: step ms {[round(t, 1) for t in times]}, median of 2-{steps} "
            f"{statistics.median(times[1:]):.1f}; device ms {dev_ms:.1f}; forward and backward "
            f"enqueued in {host_ms:.1f} ms; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("remat_ab: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.launch import train as launch_train
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_device()
    cs.phase_build()
    dev = torch.device("cuda")
    launch_train.init_distributed(dev)
    mesh = launch_train.make_mesh({"data": 1}, dev)
    order = ["none", "full", "dots"]
    for r in range(args.rounds):
        for remat in (order if r % 2 == 0 else order[::-1]):
            print(one(remat, args.steps, mesh, dev, cs), flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
