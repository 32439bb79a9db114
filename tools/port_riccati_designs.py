#!/usr/bin/env python3
"""Time the CUDA Riccati kernel of mpc_ilqr_tpu_torch (K4: riccati_backward
and riccati_backward_wide) against an earlier design of it, on one GPU.

    git archive <commit> mpc_ilqr_tpu_torch | tar -x -C logs/parent
    python3 tools/port_riccati_designs.py logs/parent/mpc_ilqr_tpu_torch

The earlier design is the csrc/ of that copy of the package; it must have the
batched entry point (mpc_riccati_backward_batched, with its global scratch
argument). The inputs are made once and saved: chip_smoke.py's long-horizon
inputs (N=100, and their last 25 knots for N=25), its hands inputs (H1 with
hands, nx=103, nu=45: N=25 at dt 0.02 and N=100 at dt 0.01), and its
reference cases (riccati_problem) at every size both designs take. The two
designs then run in turns (old, new, new, old, each its own process;
tools/design_turns.py), one instance per launch: the earlier design through
its batched entry point with the global scratch it asks for, the current
one through the same entry at nx <= 64, nu <= 32 and through its wide entry
on rows padded as the op pads them above (the op's own path). Prints each design's
shared memory for H1 and for the hands sizes, each turn's ms per launch
(CUDA events over --reps launches), max|new - old| for K and kff, each
design's distance from the plain version in float64 beside plain float32's,
each design's max|kernel - plain| on the reference cases with their
non-finite steps, and nvidia-smi's name and power limit.
"""
import os

import numpy as np

import design_turns as dt

WORK = os.path.join(dt.ROOT, "logs", "riccati_compare")
INPUTS = os.path.join(WORK, "inputs.npz")
NAMES = ("A", "B", "lx", "lu", "lxx", "luu")
OLD_LIMIT = (128, 64)  # the earliest design with the batched entry point takes nx, nu up to this


def _cases():
    """{label: (six input arrays, λ, pd_bump, timed)}: the long-horizon inputs at
    N=100 and N=25, the hands inputs at N=25 and N=100, then chip_smoke's
    reference cases that both designs take."""
    import chip_smoke as cs

    z = np.load(INPUTS)
    lh = [z[n] for n in NAMES]
    pd = float(z["pd"])
    cases = {f"long horizon N={n}": ([a[100 - n:] for a in lh], float(z["reg"]), pd, True)
             for n in (100, 25)}
    for n in (25, 100):
        cases[f"hands N={n}"] = ([z[f"hands{n}_{k}"] for k in NAMES], float(z["hands_reg"]),
                                 float(z["hands_pd"]), True)
    for N, nx, nu, case, reg in cs.RICCATI_CASES:
        if nx <= OLD_LIMIT[0] and nu <= OLD_LIMIT[1]:
            cases[f"({N}, {nx}, {nu}) {case}"] = (cs.riccati_problem(N, nx, nu, case), reg, pd,
                                                  False)
    return cases


def turn(args):
    """Every case through one design; outputs and times saved to args.out."""
    import torch
    from chip_smoke import event_ms

    lib = dt.library(args, WORK)
    print(f"{args.turn} design, shared memory per block or CTA: H1 "
          f"{lib.mpc_riccati_smem_bytes(51, 19)} bytes, hands "
          f"{lib.mpc_riccati_smem_bytes(103, 45)} bytes, global scratch for hands "
          f"{4 * lib.mpc_riccati_scratch_floats(103, 45)} bytes")
    stream = torch.cuda.current_stream().cuda_stream
    saved = {}
    for label, (arrays, reg, pd, timed) in _cases().items():
        a = [torch.as_tensor(x, dtype=torch.float32, device="cuda").contiguous() for x in arrays]
        N, nx, nu = a[0].shape[0], a[0].shape[1], a[1].shape[2]
        reg_d = torch.tensor([reg], dtype=torch.float32, device="cuda")
        K, kff = torch.empty((N, nu, nx), device="cuda"), torch.empty((N, nu), device="cuda")
        n_scratch = lib.mpc_riccati_scratch_floats(nx, nu)
        scratch = torch.zeros((max(n_scratch, 1),), device="cuda")
        wide = hasattr(lib, "mpc_riccati_cluster") and (nx > 64 or nu > 32)
        if wide:  # the cluster design, on rows padded as the op pads them
            from mpc_ilqr_tpu_torch.ops.riccati import pad_rows
            padded, ldx, ldu = pad_rows(*a)

        def call():
            if wide:
                rc = lib.mpc_riccati_backward_wide(
                    *(t.data_ptr() for t in padded), reg_d.data_ptr(), pd, K.data_ptr(),
                    kff.data_ptr(), ldx, ldu, 1, N, nx, nu, stream)
            else:
                rc = lib.mpc_riccati_backward_batched(
                    *(t.data_ptr() for t in a), reg_d.data_ptr(), pd, K.data_ptr(),
                    kff.data_ptr(), scratch.data_ptr(), 1, N, nx, nu, stream)
            assert rc == 0, lib.mpc_error_string(rc)

        call()
        torch.cuda.synchronize()
        saved[f"{label}/K"], saved[f"{label}/kff"] = K.cpu().numpy(), kff.cpu().numpy()
        if timed:
            saved[f"ms/{label}"] = event_ms(call, args.reps)
    np.savez(args.out, **saved)


def _max(d):
    return float(d.max()) if d.size else 0.0


def compare(args):
    import torch
    import chip_smoke as cs
    from mpc_ilqr_tpu_torch.ops import riccati

    os.makedirs(WORK, exist_ok=True)
    li = cs.long_horizon_inputs()
    hands = {n: cs.hands_inputs(n, dt_) for n, dt_ in cs.HANDS_SIZES}
    np.savez(INPUTS, **{n: t.cpu().numpy() for n, t in zip(NAMES, li["args"])},
             **{f"hands{n}_{k}": t.cpu().numpy() for n, h in hands.items()
                for k, t in zip(NAMES, h["args"])},
             reg=li["prob"].cfg.reg_init, pd=li["prob"].cfg.pd_bump,
             hands_reg=hands[25]["prob"].cfg.reg_init, hands_pd=hands[25]["prob"].cfg.pd_bump)
    runs = dt.run_turns(__file__, args, WORK)
    old, new = runs[0], runs[1]
    print(f"old: {args.old}; new: the package's csrc")
    for label, (arrays, reg, pd, timed) in _cases().items():
        a = [torch.as_tensor(x, device="cuda") for x in arrays]
        p32 = riccati.backward_pass_plain(*[t.float() for t in a], reg, pd)
        p64 = riccati.backward_pass_plain(*[t.double() for t in a], reg, pd)
        print(f"{label}: {dt.times(runs, label)}" if timed else f"{label}:")
        for j, out in enumerate(("K", "kff")):
            o_, n_ = old[f"{label}/{out}"], new[f"{label}/{out}"]
            w32, w64 = p32[j].cpu().numpy(), p64[j].cpu().numpy()
            fin = np.isfinite(w64)
            line = (f"  {out}: max|new-old| {_max(np.abs(n_ - o_)[fin]):.3e}; non-finite steps "
                    f"old {int((~np.isfinite(o_)).reshape(len(o_), -1).any(1).sum())}, new "
                    f"{int((~np.isfinite(n_)).reshape(len(n_), -1).any(1).sum())}, plain "
                    f"{int((~fin).reshape(len(fin), -1).any(1).sum())}")
            if timed:
                line += (f"; from float64: old {_max(np.abs(o_ - w64)):.3e}, new "
                         f"{_max(np.abs(n_ - w64)):.3e}, plain32 {_max(np.abs(w32 - w64)):.3e}")
            else:
                f32 = np.isfinite(w32)
                line += (f"; max|kernel-plain32|: old {_max(np.abs(o_ - w32)[f32]):.3e}, new "
                         f"{_max(np.abs(n_ - w32)[f32]):.3e}")
            print(line)


if __name__ == "__main__":
    dt.main(__doc__, "an earlier copy of the package (its csrc/)", turn, compare)
