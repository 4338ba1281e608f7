"""End-to-end training with a restart on another mesh (twin of
``examples/train_end_to_end.py``): phase 1 trains on mesh 4x2 (data 4,
model 2) and checkpoints; phase 2 restores that checkpoint re-sharded onto
2x2x2 (pod, data, model: hierarchical FSDP over two pods, tensor and expert
parallelism over two) and trains on to the end.

    PYTHONPATH=src python -m repro_torch.launch.end_to_end --tiny --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.end_to_end --tiny \
        --device cpu --ckpt ck

Without ``torchrun`` it spawns eight ranks itself, which meet on a free
localhost port (gloo with ``--device cpu``, else NCCL on eight cards).
``--tiny`` runs yi-9b's smoke configuration at S=64 for at most 40 steps;
without it, granite-moe-1b-a400m's smoke configuration at S=256.  The
checkpoint goes to ``--ckpt`` (required under ``torchrun``), by default a
temporary directory removed at the end.  Phase 2 ends with the control
plane's report of its job (``--plane-report``), as the reference's does.
"""
from __future__ import annotations

import argparse
import os
import socket
import tempfile

import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.launch.train import main as train_main

WORLD = 8


def phases(steps: int, tiny: bool, ckpt: str, device: str):
    """(phase 1's, phase 2's) arguments of ``launch.train.main``."""
    if tiny:
        arch = ["--arch", "yi_9b", "--smoke", "--seq", "64", "--batch", "8"]
        steps = min(steps, 40)
    else:
        arch = ["--arch", "granite_moe_1b_a400m", "--smoke", "--seq", "256", "--batch", "16"]
    half = steps // 2
    common = arch + ["--lr", "1e-3", "--ckpt", ckpt, "--device", device]
    return (common + ["--steps", str(half), "--mesh", "4x2", "--ckpt-every", str(half)],
            common + ["--steps", str(steps), "--mesh", "2x2x2", "--resume", "--plane-report"])


def run(first, second) -> float:
    """Both phases in this rank; returns the final loss."""
    rank0 = int(os.environ["RANK"]) == 0
    if rank0:
        print(f"=== phase 1: {first[first.index('--steps') + 1]} steps on mesh 4x2 "
              f"(checkpoint at end) ===", flush=True)
    train_main(first)
    if rank0:
        print("=== phase 2: simulate node loss -> elastic restart on 2x2x2 ===", flush=True)
    loss = train_main(second)
    if rank0:
        print(f"trained {second[second.index('--steps') + 1]} steps across a mesh change; "
              f"final loss {loss:.4f}", flush=True)
        print("(the control-plane report above replayed this job through the "
              "real Shim/Controller/RailOrchestrator stack)", flush=True)
    dist.destroy_process_group()
    return loss


def _spawned(rank: int, port: int, first, second):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    run(first, second)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=None)
    args = ap.parse_args(argv)

    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if torchrun and (int(os.environ["WORLD_SIZE"]) != WORLD or args.ckpt is None):
        ap.error(f"under torchrun: {WORLD} processes, and --ckpt a directory every rank sees")
    with tempfile.TemporaryDirectory() as tmp:
        first, second = phases(args.steps, args.tiny, args.ckpt or os.path.join(tmp, "ck"),
                               args.device)
        if torchrun:
            run(first, second)
        else:
            mp.start_processes(_spawned, args=(_free_port(), first, second), nprocs=WORLD,
                               start_method="spawn")


if __name__ == "__main__":
    main()
