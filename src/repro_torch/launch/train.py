"""Training driver: FSDP (or HSDP) over photonic rails (or EPS), tensor and
expert parallelism over the model axis, with synthetic data, checkpointing
and restart on another mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi_9b --smoke \
        --device cpu --steps 4 --mesh 1x1 --batch 8 --seq 32 --ckpt ck --ckpt-every 2
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch yi_9b --smoke --device cpu --mesh 2x1x2 --batch 8 --seq 32 \
        --hsdp --compress --ckpt ck --resume

Port of ``repro.launch.train``.  ``--mesh`` is DxM or PxDxM (pod, data,
model) as there, and the product is the world size; M > 1 is the model axis
of tensor and expert parallelism.  Under ``torchrun`` (``RANK`` and ``WORLD_SIZE``
set) it joins that group; otherwise it forms a group of one process itself.
Runs on CUDA with NCCL unless ``--device cpu`` is given (gloo); if CUDA is
asked for and absent it raises rather than running on the CPU.
``--lr`` is AdamW's peak learning rate; ``--hsdp`` and ``--compress``
select HSDP and its int8 pod exchange; ``--ckpt DIR`` saves there at the
end (and every ``--ckpt-every`` steps), and with ``--resume`` restores from
it, re-sharded for this mesh, and continues from its step: all as there,
in the same checkpoint format.  ``--plane-report`` replays the job through
the control plane after training (``plane_report``, the simulator's
``mesh_plane_profile`` at ``--ocs-latency`` seconds a reconfiguration) and
rank 0 prints its telemetry, as there.
"""
from __future__ import annotations

import argparse
import math
import os
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs.base import get_config
from repro_torch.launch.serve import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.train.data import DataConfig, synth_batch
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import TrainSetup, init_sharded_state, make_train_step


def parse_mesh(s: str) -> dict:
    """"DxM" or "PxDxM" -> {axis: size}, the mesh's dims in order (pod,
    data, model)."""
    dims = tuple(int(x) for x in s.lower().split("x"))
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise ValueError(f"--mesh {s}: DxM or PxDxM")
    return dict(zip(("data", "model") if len(dims) == 2 else ("pod", "data", "model"), dims))


def init_distributed(device: torch.device) -> None:
    """Join the ``torchrun`` group, or form a group of one process."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(axes: dict, device: torch.device):
    if math.prod(axes.values()) != dist.get_world_size():
        raise ValueError(f"mesh {axes} needs {math.prod(axes.values())} processes, "
                         f"the group has {dist.get_world_size()}")
    return init_device_mesh(device.type, tuple(axes.values()), mesh_dim_names=tuple(axes))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--fabric", default="photonic", choices=["photonic", "eps"])
    ap.add_argument("--hsdp", action="store_true")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    add_plane_flags(ap)
    args = ap.parse_args(argv)

    try:
        axes = parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    device = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=args.smoke)
    init_distributed(device)
    mesh = make_mesh(axes, device)
    setup = TrainSetup(cfg=cfg, fabric=args.fabric, hsdp=args.hsdp,
                       compress_pod_grads=args.compress, accum=args.accum,
                       opt=OptConfig(lr=args.lr, warmup_steps=10))
    dc = DataConfig(seq_len=args.seq, global_batch=args.batch)
    tpl = tf.init_lm(cfg, device="meta")
    rank0 = dist.get_rank() == 0
    start = 0
    if args.resume and args.ckpt:
        params, opt, ef, extra = ckpt.restore(args.ckpt, setup, mesh, tpl, device)
        start = int(extra.get("step", 0))
        if rank0:
            print(f"resumed from step {start}", flush=True)
    else:
        params, opt, ef = init_sharded_state(setup, mesh, seed=0, device=device)
    step_fn = make_train_step(setup, mesh, tpl)

    def save(n: int):
        ckpt.save(args.ckpt, params, opt, ef, fd_tree=step_fn.fd_tree, fabric=step_fn.fabric,
                  td_tree=step_fn.td_tree, model=step_fn.model, extra={"step": n})

    t0 = time.time()
    m = None
    for step in range(start, args.steps):
        batch = synth_batch(cfg, dc, step, device=device)
        params, opt, ef, m = step_fn(params, opt, ef, batch)
        if rank0 and (step % 5 == 0 or step == args.steps - 1):
            print(f"step {step:4d} loss {float(m['loss']):.4f} ce {float(m['ce']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} ({time.time() - t0:.1f}s)", flush=True)
        if args.ckpt and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            save(step + 1)
            if rank0:
                print(f"checkpointed @ {step + 1}", flush=True)
    if args.ckpt:
        save(args.steps)
    if args.plane_report:
        plane_report(cfg, mesh, args.batch, args.seq, args.ocs_latency)
    return float(m["loss"]) if m is not None else math.nan


def add_plane_flags(ap: argparse.ArgumentParser) -> None:
    """The drivers' ``--plane-report`` and ``--ocs-latency``, as the JAX
    package's."""
    ap.add_argument("--plane-report", action="store_true",
                    help="after the run, replay this job's schedule through the real "
                         "photonic control plane (repro_torch.core.plane) and print its "
                         "telemetry")
    ap.add_argument("--ocs-latency", type=float, default=0.05,
                    help="OCS reconfiguration latency for --plane-report")


def plane_report(cfg, mesh, global_batch: int, seq_len: int, ocs_latency: float):
    """What the photonic control plane would do for this training job: one
    simulated steady-state iteration through the real Shim / Controller /
    RailOrchestrator stack (``sim.opus_sim.mesh_plane_profile``, the JAX
    package's mesh -> JobConfig mapping).  ``mesh``: ``parse_mesh``'s dict
    or a ``DeviceMesh``.  Rank 0 prints the JAX driver's lines; every rank
    returns the profile."""
    from repro_torch.sim.opus_sim import mesh_plane_profile
    ax = dict(mesh) if isinstance(mesh, dict) else dict(zip(mesh.mesh_dim_names, mesh.shape))
    p = mesh_plane_profile(cfg, ax, global_batch=global_batch, seq_len=seq_len,
                           ocs_latency=ocs_latency)
    if dist.is_initialized() and dist.get_rank() != 0:
        return p
    print(f"control plane report (TP={p['tp']} FSDP={p['fsdp']}, "
          f"OCS {ocs_latency*1e3:.0f} ms):")
    over = p["overhead_vs_native"]
    print(f"  modeled step {p['modeled_step_s']:.4g}s "
          + (f"({100*over:.2f}% over native EPS), " if over is not None
             else "(TP-only: no scale-out traffic), ")
          + f"{p['n_reconfigs']} reconfigs")
    print(f"  {p['n_barriers']} barriers, {p['n_dispatches']} dispatches, "
          f"{p['n_topo_writes']} topo_writes, "
          f"{p['n_ports_programmed']} ports programmed")
    rm = p["rail_mapping"]
    ports = rm["ports_per_rail"]
    span = f"port {ports[0]}" if len(ports) == 1 else f"ports {ports[0]}-{ports[-1]}"
    print(f"  rail mapping: TP={rm['scale_up_ways']} on scale-up, "
          f"{rm['scale_out_ranks']} scale-out rank"
          f"{'' if rm['scale_out_ranks'] == 1 else 's'}/rail ({span}"
          + (", rail-silent)" if rm["rail_silent"] else ")"))
    return p


if __name__ == "__main__":
    main()
