#!/usr/bin/env python3
"""Time the CUDA rollout kernels of mpc_ilqr_tpu_torch (K1 rollout_open,
K2/K3 rollout_feedback) against an earlier design of them, on one GPU.

    git archive <commit> mpc_ilqr_tpu_torch | tar -x -C logs/parent
    python3 tools/port_rollout_designs.py logs/parent/mpc_ilqr_tpu_torch

The earlier design is the csrc/ of that copy of the package, with the
ops/step_plan.py that packs its model. The two designs run in turns (old,
new, new, old, each its own process; tools/design_turns.py): CUDA events
over 50 launches of K1, K2 at A=1 and K3 at A=7, on chip_smoke.py's kernel
inputs, at N=25 on the flagship's model and at N=100 on the long-horizon
model. Prints each turn's ms per
launch, whether the two designs' outputs are equal bit for bit, and
nvidia-smi's name and power limit.
"""
import importlib.util
import os
import sys

import numpy as np

import design_turns as dt

WORK = os.path.join(dt.ROOT, "logs", "rollout_compare")


def _plan_module(path: str):
    spec = importlib.util.spec_from_file_location("step_plan_old", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclass looks its module up there
    spec.loader.exec_module(mod)
    return mod


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
    from chip_smoke import event_ms, kernel_inputs, standing_problem
    from mpc_ilqr_tpu_torch import scenarios
    from mpc_ilqr_tpu_torch.ops import step_plan

    lib = dt.library(args, WORK)
    plan_mod = (_plan_module(os.path.join(args.old, "ops", "step_plan.py"))
                if args.turn == "old" else step_plan)
    flag, (lh, _) = standing_problem(), scenarios.long_horizon(tuned=True)
    saved = {}
    for label, prob in (("N=25 flagship", flag), ("N=100 long horizon", lh)):
        inp = kernel_inputs(prob.model, prob.cfg.alphas, prob.cfg.N)
        for name, call in _cases(lib, plan_mod.build_step_plan(prob.model), prob.model,
                                 inp).items():
            key = f"{label} {name}"
            for j, t in enumerate(call()):
                saved[f"{key}/{j}"] = t.cpu().numpy()
            saved[f"ms/{key}"] = event_ms(call, args.reps)
    np.savez(args.out, **saved)


def compare(args):
    runs = dt.run_turns(__file__, args, WORK)
    print(f"old: {args.old}; new: the package's csrc")
    for key in (k[3:] for k in runs[0].files if k.startswith("ms/")):
        same = all(np.array_equal(runs[0][k], runs[1][k])
                   for k in runs[0].files if k.startswith(key + "/"))
        print(f"{key}: {dt.times(runs, key)}; outputs bit for bit equal: {same}")


if __name__ == "__main__":
    dt.main(__doc__, "an earlier copy of the package (its csrc/ and ops/step_plan.py)", turn,
            compare)
