"""Turns of two designs of mpc_ilqr_tpu_torch's CUDA kernels, for the tools
that time one design against the other on one GPU (port_rollout_designs.py,
port_riccati_designs.py).

The earlier design is the csrc/ of an earlier copy of the package, built
under logs/ (which git ignores) with the package's nvcc flags. The two
designs run in turns, old, new, new, old, each turn a process of its own so
that two libraries with the same kernel names never share one (two in one
process crashed with an illegal instruction). A tool gives `main` its turn
(run every case through one design, save outputs and times to --out as an
npz) and its comparison (read the four turns' npz).
"""
import argparse
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
TURNS = ("old", "new", "new", "old")


def library(args, work):
    """The C library of this turn's design: the earlier csrc/ built under
    `work`, or the package's own."""
    from mpc_ilqr_tpu_torch.ops import _build

    if args.turn == "old":
        return _build.bind(_build.build(os.path.join(args.old, "csrc"), os.path.join(work, "old")))
    return _build.library()


def run_turns(script, args, work):
    """`script` once per turn, each in its own process; the four turns' npz."""
    os.makedirs(work, exist_ok=True)
    runs = []
    for i, who in enumerate(TURNS):
        path = os.path.join(work, f"turn{i}_{who}.npz")
        subprocess.run([sys.executable, os.path.abspath(script), args.old, "--turn", who,
                        "--out", path, "--reps", str(args.reps)], check=True)
        runs.append(np.load(path))
    return runs


def times(runs, key):
    """Each turn's ms per launch of `key`, as old / old and new / new, with
    old's mean over new's."""
    t = [float(r[f"ms/{key}"]) for r in runs]
    o, n = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    return (f"old {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f} / {t[2]:.4f} ms per launch "
            f"(old/new {o / n:.2f}x)")


def main(doc, old_help, turn, compare):
    """Runs `turn(args)` in a turn's process, else `compare(args)` and then
    nvidia-smi's name and power limit."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("old", help=old_help)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--turn", choices=("old", "new"), help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        turn(args)
        return
    compare(args)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
