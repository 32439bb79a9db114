#!/usr/bin/env python3
"""Time the CUDA rollout kernels of mpc_ilqr_tpu_torch (K1 rollout_open,
K2/K3 rollout_feedback) against an earlier design of them, on one GPU.

    git archive <commit> mpc_ilqr_tpu_torch | tar -x -C logs/parent
    python3 tools/port_rollout_designs.py logs/parent/mpc_ilqr_tpu_torch

The earlier design is the csrc/ of that copy of the package, with the
ops/step_plan.py that packs its model. It is built under logs/ (which git
ignores) with the package's nvcc flags. The two designs then run in turns
(old, new, new, old), each turn a process of its own so that the two
libraries never share one: CUDA events over 50 launches of K1, K2 at A=1
and K3 at A=7, on chip_smoke.py's kernel inputs, at N=25 on the flagship's
model and at N=100 on the long-horizon model. Prints each turn's ms per
launch, whether the two designs' outputs are equal bit for bit, and
nvidia-smi's name and power limit.
"""
import argparse
import importlib.util
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
WORK = os.path.join(ROOT, "logs", "rollout_compare")


def _plan_module(path: str):
    spec = importlib.util.spec_from_file_location("step_plan_old", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclass looks its module up there
    spec.loader.exec_module(mod)
    return mod


def _event_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def _cases(lib, plan, model, inp):
    """{name: launch} of K1, K2 (A=1) and K3 (A=7) through the C interface,
    each launch returning its output tensors."""
    import torch

    N, stream = inp["us"].shape[0], torch.cuda.current_stream().cuda_stream
    margs = (plan.fbuf.data_ptr(), plan.ibuf.data_ptr(), plan.fbuf.numel(), plan.ibuf.numel(),
             plan.B, plan.nq, plan.nv, plan.nu, plan.ncp)
    out = {A: (torch.empty((A, N + 1, model.nx), device="cuda"),
               torch.empty((A, N, model.nu), device="cuda")) for A in (1, 7)}

    def open_():
        xs = out[1][0]
        rc = lib.mpc_rollout_open(*margs, inp["x0"].data_ptr(), inp["us"].data_ptr(),
                                  xs.data_ptr(), N, 1, model.timestep, stream)
        assert rc == 0, lib.mpc_error_string(rc)
        return (xs,)

    def feedback(A, xs, us):
        rc = lib.mpc_rollout_feedback(
            *margs, *(inp[k].data_ptr() for k in ("x0", "xbar", "ubar", "K", "kff")),
            inp["a1" if A == 1 else "a7"].data_ptr(), A, xs.data_ptr(), us.data_ptr(), N, 1,
            model.timestep, stream)
        assert rc == 0, lib.mpc_error_string(rc)
        return xs, us

    return {"K1 rollout_open": open_,
            "K2 rollout_feedback A=1": lambda: feedback(1, *out[1]),
            "K3 rollout_feedback A=7": lambda: feedback(7, *out[7])}


def turn(args):
    """Every case of one design; outputs and times saved to args.out."""
    from chip_smoke import kernel_inputs, standing_problem
    from mpc_ilqr_tpu_torch import scenarios
    from mpc_ilqr_tpu_torch.ops import _build, step_plan

    if args.turn == "old":
        lib = _build.bind(_build.build(os.path.join(args.old, "csrc"), os.path.join(WORK, "old")))
        plan_mod = _plan_module(os.path.join(args.old, "ops", "step_plan.py"))
    else:
        lib, plan_mod = _build.library(), step_plan
    flag, (lh, _) = standing_problem(), scenarios.long_horizon(tuned=True)
    saved = {}
    for label, prob in (("N=25 flagship", flag), ("N=100 long horizon", lh)):
        inp = kernel_inputs(prob.model, prob.cfg.alphas, prob.cfg.N)
        for name, call in _cases(lib, plan_mod.build_step_plan(prob.model), prob.model,
                                 inp).items():
            key = f"{label} {name}"
            for j, t in enumerate(call()):
                saved[f"{key}/{j}"] = t.cpu().numpy()
            saved[f"ms/{key}"] = _event_ms(call, args.reps)
    np.savez(args.out, **saved)


def compare(args):
    os.makedirs(WORK, exist_ok=True)
    runs = []
    for i, who in enumerate(("old", "new", "new", "old")):
        path = os.path.join(WORK, f"turn{i}_{who}.npz")
        subprocess.run([sys.executable, os.path.abspath(__file__), args.old, "--turn", who,
                         "--out", path, "--reps", str(args.reps)], check=True)
        runs.append(np.load(path))
    print(f"old: {args.old}; new: the package's csrc")
    for key in (k[3:] for k in runs[0].files if k.startswith("ms/")):
        t = [float(r[f"ms/{key}"]) for r in runs]
        o, n = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        same = all(np.array_equal(runs[0][k], runs[1][k])
                   for k in runs[0].files if k.startswith(key + "/"))
        print(f"{key}: old {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f} / {t[2]:.4f} ms per launch "
              f"(old/new {o / n:.2f}x); outputs bit for bit equal: {same}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", help="an earlier copy of the package (its csrc/ and ops/step_plan.py)")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--turn", choices=("old", "new"), help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        turn(args)
    else:
        compare(args)


if __name__ == "__main__":
    main()
