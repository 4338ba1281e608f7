#!/usr/bin/env python3
"""``chip_smoke.py``'s mamba training phase from another tree and from
this one in turns on one card: old, new, new, old.

    python3 scripts/phase_ab.py --old-tree PATH

Run on a machine with an NVIDIA GPU and nvcc.  PATH is the root of another
checkout (for instance the parent commit from ``git archive``, unpacked
under ``build/``).  Each turn is a process of its own started in that
tree's root: it builds that tree's kernels (``phase_build``) and runs
``phase_train`` at mamba2-370m, B=1 S=4096 (four steps by the host clock,
and a profiled step's device time by kernel), so that each tree runs its
own code end to end; the phase's log lines are printed under the tree's
label.  Ends with the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the call made in each tree's root, and the tag its log lines carry
CALL = 'c.phase_train(c.SSM_TRAIN_ARCH, 1, tag="mamba train")'
TAG = "[mamba train]"


def run_phase(tree: Path) -> str:
    """The phase's output, run in a process of its own in ``tree``."""
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "import torch\n"
            "torch.backends.cuda.matmul.allow_tf32 = False\n"
            "torch.backends.cudnn.allow_tf32 = False\n"
            "import chip_smoke as c\n"
            "c.phase_device(); c.phase_build()\n" + CALL + "\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: the phase failed:\n{out.stdout[-2000:]}{out.stderr[-2000:]}")
    return out.stdout + out.stderr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-tree", type=Path, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("phase_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    trees = {"old": args.old_tree.resolve(), "new": ROOT}
    for label in ("old", "new", "new", "old"):
        for line in run_phase(trees[label]).splitlines():
            if line.startswith(TAG):
                print(f"[{label}] {line}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
