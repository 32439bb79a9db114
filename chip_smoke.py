#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mpc_ilqr_tpu_torch) end to end on one GPU.

    python3 chip_smoke.py            # all phases
    python3 chip_smoke.py --kernels  # stop after the kernel checks

Phases, each printing its wall seconds:
  1. device   the card's name and count, and nvidia-smi's name/power limit
  2. build    nvcc of csrc/*.cu into build/torch_kernels/ (ptxas lines shown)
  3. kernels  K1, K2 (A=1) and K3 (A=7) at the main path's shapes (H1, N=25)
              against their plain PyTorch versions on the same inputs: at
              atol 2e-4 (the JAX package's kernel tolerance) on its kernel
              tests' model, with the kernel's and plain float32's distance
              from float64 printed beside it; on the main path's model
              against float64, at atol 2e-4 over the first two steps from
              standing (the stiction regime) and, over N=25, no further than
              float32 allows; then timed with CUDA events
  4. loop     config.yaml with the standing references: 15 MPC steps of
              run_closed_loop on the card in float32, held to finite states,
              every solve_ok, base z in (1.0, 1.1), last cost below the
              first, and K1/K2 launched; then timed once more
  5. riccati  K4's shared memory (its registers and spills are among
              phase 2's ptxas lines); K4 against its plain version: on
              tests/test_ops.py's random inputs at (N, nx, nu) = (10, 51, 19)
              and (4, 13, 5), and where the PD bump fires, at the JAX
              package's Riccati bar (rtol 2e-3, atol 2e-4,
              tests/test_ops.py:36-37); on the long-horizon path's own inputs
              (N=100) against float64, K and kff each no further than float32
              allows; each reading beside K4's first design's; then timed at
              N=25 and N=100 beside the plain version and the port's
              torch.linalg loop
  6. long horizon  scenarios.long_horizon (N=100, dt 0.01, backward "pallas")
              in two variants, (a) tuned, 5 MPC steps and (b) tuned, one
              iteration, a solve every 2nd of 6 control steps; each held to
              finite states, every solve_ok, base z in (1.0, 1.1), K4 launched
              once per backward pass and K1/K2 launched, (b) also to its last
              cost below its first; then timed once more, and one solver
              iteration at N=100 broken down
  7. walking  config.yaml as shipped (the walking references, N=25, the
              shipped solver) through the system's entry point,
              runner.run_simulation, for the config's 100 sim steps, with the
              native step log and the trajectory logs under
              logs/chip_smoke_walking/ and a Profiler; held to finite states,
              base z in (1.0, 1.1), the native writer, no dropped row, the log's
              lines and header, K1/K2 launched, and solve_ok and the
              failed-solve abort no worse than the JAX package's own walking run
              (WALK_ANCHOR); then the CLI once, `python -m
              mpc_ilqr_tpu_torch.run_mpc --standing --steps 3 --quiet
              --profile`, which must run on cuda
  8. batched  (a) scenarios.batched_linesearch: 8 seeds x 16 alphas, N=25,
              float32, one batched device-side solve (solve_batched), timed
              as solves per second over 3 calls after a warm-up; held to
              finite costs and each seed's cost and ubar against the same
              device-side solve run on that seed alone (SEED_COST_RTOL,
              SEED_UBAR_ATOL). (b) scenarios.fleet: 1024 randomised H1s in
              chunks of 128: one chunk through fleet_step_once (the warm-up),
              then the cold-start and the warm-start fleet steps, both timed;
              held to finite controls for every instance; then one chunk
              through fleet_step_once under
              torch.cuda.set_sync_debug_mode("error"); each single chunk
              equal to the chunked step's first chunk; the peak memory and
              the time of each part of a chunk. Both paths take no kernel:
              their launch counts must read 0
Each path is driven with every launch count set to 0 just before it and read
just after. Then one `kernels` JSON line and, last, the `ok` JSON line. Any
failed check exits non-zero before the result lines. Imports only the port,
torch, numpy and the standard library.
"""
import faulthandler
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ATOL = 2e-4  # tests/test_ops.py:165, :214
N_STEPS = 15
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
ANCHORS = "TPU-era quality anchors (information only): final cost 0.4000-0.4001, base_z 1.042690"
LH_ANCHORS = ("TPU-era long-horizon anchors (information only): final cost 2.3070-2.3072, "
              "base_z 1.0430")
# The JAX package's own walking run (config.yaml as shipped, float32, on the CPU;
# tools/walking_anchor.py --package jax): 53 of its 54 solves ok, the first failure
# at step 53, where run_simulation's abort (a failed solve past step 15) ends it.
# Phase 7 holds the port to no more failed solves and no earlier abort.
WALK_ANCHOR = dict(steps_run=54, failed=(53,), final_cost=71560.2656, base_z=1.04132819,
                   mean_err=(0.00191798, 0.00081349, 0.00283948),
                   max_err=(0.00358117, 0.00184174, 0.00335884))
RICCATI_RTOL, RICCATI_ATOL = 2e-3, 2e-4  # tests/test_ops.py:36-37
RICCATI_REG = 2.0 ** -20  # ~1e-6, exact in float32 (the bump case needs an exact zero pivot)
RICCATI_T_BAD = 6  # the step where riccati_problem's bump cases put their pivot
# Phase 5's reference cases: (N, nx, nu, riccati_problem case, λ).
RICCATI_CASES = ((10, 51, 19, "plain", 1e-6), (4, 13, 5, "plain", 1e-5),
                 (10, 51, 19, "rescued", RICCATI_REG), (10, 51, 19, "indefinite", RICCATI_REG))
# K4's first design (seven block phases per knot, one output per thread) on
# phase 5's inputs, printed beside this design's readings: max|kernel - plain|
# per reference case and |kernel - plain64| of K and kff on the long-horizon
# inputs (tools/port_riccati_designs.py; NVIDIA H100 80GB HBM3, 700.00 W).
FIRST_K4 = {(10, 51, 19, "plain"): 2.384e-06, (4, 13, 5, "plain"): 3.576e-07,
            (10, 51, 19, "rescued"): 1.907e-06, (10, 51, 19, "indefinite"): 9.537e-07,
            "K": 1.397e-2, "kff": 1.223e-3}
# Phase 8's bars on the batched seed solve against the same device-side solve run on
# one seed at a time (float32: batched and single products round differently).
SEED_COST_RTOL, SEED_UBAR_ATOL = 1e-4, 3e-3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str, t0: float) -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s")


def chain_flops(model, xs, feedback):
    """Floating-point operations that the dynamics steps (csrc/step.cuh)
    starting from the states xs (..., nx) need, counting structurally
    non-zero work only. A body's Jacobian has columns at its n_b ancestor
    dofs alone (`ancestor_mask`), so its Jacobian, velocity, bias and
    mass-matrix terms are n_b-sized; M and the lhs are symmetric, so one
    triangle counts; a contact point adds its Jacobian, velocity, friction
    law, lhs and elastic terms only while it touches the ground in the state
    the step starts from. A feedback step adds u = ū + αk + K(x − x̄)."""
    import torch
    from mpc_ilqr_tpu_torch.dynamics import engine
    from mpc_ilqr_tpu_torch.dynamics.kinematics import forward_kinematics

    B, nq, nv, nu, ncp, nx = model.nbody, model.nq, model.nv, model.nu, model.ncp, model.nx
    nb = model.ancestor_mask.double().sum(1).cpu()
    nc = nb[list(model.cp_body_idx)]
    tri = lambda n: n * (n + 1) / 2
    fixed = (B * 130  # FK: 3x3 products, hinge rotation
             + nv * 18 + B * 63 + ncp * 18  # dof axes/anchors, CoMs, Rin, contact points
             + float(nb.sum()) * (27 + 6 + 12)  # Jacobian columns and G; body ω; bias
             + B * (60 + 75)  # RNEA, body forces and torques
             + float(tri(nb).sum()) * 18 + 2 * nv  # M (one triangle), armature, damping
             + 2 * nu + 2 * nv * nv + 3 * nv  # actuation, rhs
             + nv ** 3 / 3 + 2 * nv * nv  # Cholesky, two triangular solves
             + 2 * nq + 40)  # integration
    per_contact = nc * (12 + 6 + 2) + 20 + 9 * tri(nc)  # Jc, velocity, f_el, law, lhs
    if feedback:
        fixed += nx + nu * (2 * nx + 2)
    states = xs.reshape(-1, nx)
    active = torch.func.vmap(
        lambda x: engine.contact_geometry(model, forward_kinematics(model, x[:nq]))[3])(states)
    n_contact = float((active.double().cpu() * per_contact).sum())
    return int(round(states.shape[0] * fixed + n_contact))


def standing_problem():
    """The main path's problem: config.yaml with the standing references."""
    from mpc_ilqr_tpu_torch.io.config import load_config
    from mpc_ilqr_tpu_torch.mpc import runner

    app = load_config(os.path.join(ROOT, "config.yaml"))
    app.q_ref_path = "data/q_standing.csv"
    app.v_ref_path = "data/v_standing.csv"
    app.contact_schedule_path = "data/contact_standing.csv"
    return runner.setup(app)


def kernel_inputs(model, alphas, N):
    """The rollout kernels' inputs on the model's device at horizon N, from a
    fixed seed as in tests/test_ops.py:181-193: x0 standing, `us` at gravity
    compensation, ū those plus noise, x̄ the plain rollout of ū, random K and
    k; `a1` the first alpha, `a7` the seven after it."""
    import numpy as np
    import torch
    from mpc_ilqr_tpu_torch.dynamics import engine
    from mpc_ilqr_tpu_torch.models.robot import standing_state
    from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk

    rng = np.random.default_rng(0)
    t32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=model.device).contiguous()
    x0 = standing_state(model)
    u_grav = engine.gravity_comp(model, x0)
    ubar = (u_grav[None] + t32(0.1 * rng.normal(0, 1, (N, model.nu)))).contiguous()
    return dict(x0=x0, us=u_grav[None].repeat(N, 1).contiguous(), ubar=ubar,
                xbar=rk.rollout_plain(model, x0, ubar).contiguous(),
                K=t32(0.01 * rng.normal(0, 1, (N, model.nu, model.nx))),
                kff=t32(0.1 * rng.normal(0, 1, (N, model.nu))),
                a1=t32(alphas[:1]), a7=t32(alphas[1:]))


def long_horizon_inputs(device=None):
    """The long-horizon path's own Riccati inputs at N=100: A, B and the GN
    quadratics of window 0 along the cold-start rollout from standing at
    gravity compensation. A dict of the problem (`prob`, tuned), `x0`,
    `us`, `xs`, `window`, `A`, `B`, `quad` and `args`, the kernel's six
    inputs (A, B, lx, lu, lxx, luu), contiguous."""
    from mpc_ilqr_tpu_torch import scenarios
    from mpc_ilqr_tpu_torch.costs.quadratics import quadraticize_gn
    from mpc_ilqr_tpu_torch.costs.references import extract_window
    from mpc_ilqr_tpu_torch.dynamics import engine
    from mpc_ilqr_tpu_torch.ilqr import solver
    from mpc_ilqr_tpu_torch.models.robot import standing_state

    prob, _ = scenarios.long_horizon(tuned=True, device=device)
    m, cfg = prob.model, prob.cfg
    x0 = standing_state(m)
    us = engine.gravity_comp(m, x0)[None].repeat(cfg.N, 1).contiguous()
    xs = solver.rollout(m, cfg, x0, us, plan=prob.plan)
    window = extract_window(prob.refs, 0, cfg.N)
    A, B = solver.linearize(m, cfg, xs, us)
    quad = quadraticize_gn(m, prob.cp, window, xs, us)
    return dict(prob=prob, x0=x0, us=us, xs=xs, window=window, A=A, B=B, quad=quad,
                args=[t.contiguous() for t in (A, B, *quad)])


def riccati_flops(N, nx, nu, n_bumps):
    """Floating-point operations that the Riccati pass needs, per step: Qx,
    Qu; AᵀVxx and BᵀVxx; one triangle of the symmetric Qxx and Quu + λI and
    all of Qxu; the Cholesky (again, with the bump, at the n_bumps steps where
    it fires); the forward and back substitution of the nx+1 right-hand
    sides; W = Quu·[K | k] + [Qxuᵀ | Qu]; Vx = Qx + KᵀW_k + Qxu k; and one
    triangle of the symmetric Vxx = Qxx + KᵀW_K + Qxu K. The
    symmetrization is not counted: one triangle needs none."""
    tri = lambda n: n * (n + 1) // 2
    chol = sum((nu - k) + 1 + (nu - k - 1) * (nu - k) for k in range(nu))
    per_t = (2 * nx * nx + 2 * nx * nu  # Qx, Qu
             + 2 * nx ** 3 + 2 * nu * nx * nx  # AᵀVxx, BᵀVxx
             + 2 * nx * tri(nx) + 2 * nx * nx * nu + 2 * nx * tri(nu) + nu  # Qxx, Qxu, Quu + λI
             + chol
             + (nx + 1) * 2 * nu * nu  # forward and back substitution
             + 2 * nu * nu * (nx + 1)  # W
             + 4 * nu * nx + 4 * nu * tri(nx))  # Vx, Vxx
    return N * per_t + n_bumps * (nu + chol)


def riccati_bytes(N, nx, nu):
    """Inputs read once (A, B, lx, lu, lxx, luu, λ), outputs written once."""
    return 4 * (N * nx * nx + N * nx * nu + (N + 1) * nx + N * nu + (N + 1) * nx * nx
                + N * nu * nu + 1 + N * nu * nx + N * nu)


def riccati_problem(N, nx, nu, case="plain"):
    """tests/test_ops.py:14-26's random Riccati problem (numpy, seed 42) as
    float64 arrays A, B, lx, lu, lxx, luu. "rescued": at t=RICCATI_T_BAD,
    B_t = 0 and luu_t has -RICCATI_REG on one diagonal entry, so Quu + λI
    (λ = RICCATI_REG) has an exact zero pivot, the first factor is NaN and
    the bump makes it positive definite (k_t there is -lu/pd_bump);
    "indefinite": luu_t = -I, which the bump cannot cure, so every
    t <= RICCATI_T_BAD comes out NaN."""
    import numpy as np

    rng = np.random.default_rng(42)
    A = np.eye(nx) + 0.02 * rng.normal(size=(N, nx, nx))
    B = 0.02 * rng.normal(size=(N, nx, nu))
    lx, lu = rng.normal(size=(N + 1, nx)), rng.normal(size=(N, nu))
    lxx = np.einsum("ti,ij->tij", rng.uniform(1.0, 5.0, size=(N + 1, nx)), np.eye(nx))
    luu = np.einsum("ti,ij->tij", rng.uniform(0.1, 1.0, size=(N, nu)), np.eye(nu))
    if case == "rescued":
        B[RICCATI_T_BAD] = 0.0
        luu[RICCATI_T_BAD, 3, 3] = -RICCATI_REG
    elif case == "indefinite":
        luu[RICCATI_T_BAD] = -np.eye(nu)
    return [A, B, lx, lu, lxx, luu]


def bound(n_bytes, n_flops):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def breakdown(parts, tag, reps=5):
    """Host-clock ms per call of each part, `reps` calls after one warm-up."""
    import torch

    out = {}
    for label, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[label] = (time.perf_counter() - t0) * 1e3 / reps
        print(f"  breakdown ({tag}): {label}: {out[label]:.3f} ms (host clock)")
    return out


def host_seconds(fn, reps):
    """Mean host-clock seconds of `reps` calls of fn, each ending in synchronize()."""
    import torch

    secs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return sum(secs) / reps, out


def event_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def recording_waits(module, oks: list):
    """A stand-in for module.block_until_ready, the wait on step_once's
    output inside either package's run_simulation, that appends each step's
    solve_ok to oks (run_simulation's history, as the reference's, has no
    solve_ok)."""
    inner = module.block_until_ready

    def wait(out):
        out = inner(out)
        if isinstance(out, tuple) and len(out) == 3 and hasattr(out[2], "solve_ok"):
            oks.append(bool(out[2].solve_ok))
        return out
    return wait


def walking_quality(log_path: str) -> dict:
    """From a step log (either package's StepLogger): its header, rows, the
    final cost and base z, base z's range, and base X/Y/Z's mean and max
    |x - x_ref| against the reference row logged beside each state."""
    import numpy as np

    with open(log_path) as f:
        header = f.readline().rstrip("\n")
    d = np.atleast_2d(np.loadtxt(log_path, delimiter=",", skiprows=1))
    cols = header.split(",")
    ix, ir = cols.index("x_0"), cols.index("x_ref_0")
    err = np.abs(d[:, ix:ix + 3] - d[:, ir:ir + 3])
    return dict(header=header, rows=len(d), final_cost=float(d[-1, 2]),
                base_z=float(d[-1, ix + 2]), z_min=float(d[:, ix + 2].min()),
                z_max=float(d[:, ix + 2].max()), mean_err=tuple(map(float, err.mean(0))),
                max_err=tuple(map(float, err.max(0))))


def batched_phase(report, smi_line, reset_counts, read_counts):
    """Phase 8: scenarios.batched_linesearch and scenarios.fleet on the card,
    each held to its gates, timed, and its kernel launches recorded in
    `report` (all four read 0: the batched path takes the plain chains)."""
    import torch
    from torch.func import vmap

    from mpc_ilqr_tpu_torch import scenarios
    from mpc_ilqr_tpu_torch.costs.quadratics import quadraticize_gn
    from mpc_ilqr_tpu_torch.costs.references import extract_window
    from mpc_ilqr_tpu_torch.ilqr import solver
    from mpc_ilqr_tpu_torch.models.robot import ARRAY_FIELDS
    from mpc_ilqr_tpu_torch.mpc import controller
    from mpc_ilqr_tpu_torch.parallel import fleet as fleet_mod

    def zero_launches(label, counts):
        print(f"{label}: kernel launches {counts}")
        if any(counts.values()):
            fail(f"{label}: the batched path launched a kernel ({counts}); it takes the plain chains")
        for name in report:
            report[name]["launches_by_path"][label] = counts[name]

    # (a) scenarios.batched_linesearch: one batched solve over the seeds
    ss = scenarios.batched_linesearch()
    sp, n_seeds = ss.prob, ss.seeds.shape[0]
    solve_seeds = lambda: solver.solve_batched(sp.model, sp.cp, sp.cfg, ss.x0, ss.window, ss.seeds)
    reset_counts()
    t1 = time.perf_counter()
    sol = solve_seeds()
    counts = read_counts()
    first_s = time.perf_counter() - t1
    zero_launches("batched_linesearch", counts)
    mean_s, _ = host_seconds(solve_seeds, 3)
    print(f"batched_linesearch ({smi_line}): {n_seeds} seeds x {len(sp.cfg.alphas)} alphas, "
          f"N={sp.cfg.N}, max_iterations {sp.cfg.max_iterations}, {sp.model.dtype}: "
          f"{n_seeds / mean_s:.4f} solves/s ({mean_s * 1e3:.2f} ms per batched solve, host clock, "
          f"mean of 3 calls after one warm-up of {first_s:.2f} s)")
    print(f"  mean cost {float(sol.cost.mean()):.6f}; per seed: cost "
          f"{[round(c, 6) for c in sol.cost.tolist()]}, iterations {sol.iterations.tolist()}, "
          f"success {sol.success.tolist()}, attempts needed {sol.attempts.tolist()} of "
          f"{2 * sp.cfg.max_iterations} run")
    if not bool(torch.isfinite(sol.cost).all()):
        fail(f"batched_linesearch: non-finite cost {sol.cost.tolist()}")
    one_cfg = solver.batched_config(sp.cfg)
    worst = dict(cost=0.0, ubar=0.0)
    t1 = time.perf_counter()
    for s in range(n_seeds):
        one = solver.device_solve(sp.model, sp.cp, one_cfg, ss.x0, ss.window, ss.seeds[s])
        d_cost = abs(float(one.cost) - float(sol.cost[s])) / max(1.0, abs(float(one.cost)))
        d_u = float((one.ubar - sol.ubar[s]).abs().max())
        worst = dict(cost=max(worst["cost"], d_cost), ubar=max(worst["ubar"], d_u))
        print(f"  seed {s} alone: cost {float(one.cost):.6f} (relative gap {d_cost:.3e}), "
              f"max|ubar gap| {d_u:.3e}, iterations {int(one.iterations)}, "
              f"success {bool(one.success)}")
    torch.cuda.synchronize()
    print(f"  batched vs one at a time ({(time.perf_counter() - t1) * 1e3 / n_seeds:.2f} ms per "
          f"single-seed solve, host clock, with the gap readings): relative cost gap "
          f"{worst['cost']:.3e} (bar {SEED_COST_RTOL}), max|ubar gap| {worst['ubar']:.3e} (bar "
          f"{SEED_UBAR_ATOL})")
    if not (worst["cost"] <= SEED_COST_RTOL and worst["ubar"] <= SEED_UBAR_ATOL):
        fail(f"batched_linesearch: the batched solve parts from one seed at a time ({worst})")

    # (b) scenarios.fleet: 1024 randomised H1s in chunks of 128. The warm-up is one chunk
    # (fleet_step_once), then the cold-start fleet step and the warm-start one, both timed.
    fl = scenarios.fleet()
    fp, chunk, n = fl.prob, fl.chunk, fl.xs.shape[0]
    dev = fp.model.device
    part = lambda t: t[:chunk]
    m0 = fl.models.replace(**{f: part(getattr(fl.models, f)) for f in ARRAY_FIELDS})
    x0s = part(fl.xs)
    once = lambda states: fleet_mod.fleet_step_once(m0, fp.cp, fp.cfg, fp.refs, controller.MPCState(
        **{f: part(getattr(states, f)) for f in fleet_mod.STATE_FIELDS}), x0s)
    step = lambda states: fleet_mod.fleet_step_chunked(fl.models, fp.cp, fp.cfg, fp.refs, states,
                                                       fl.xs, chunk)
    reset_counts()
    t1 = time.perf_counter()
    warm = once(fl.states)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t1
    torch.cuda.reset_peak_memory_stats()
    runs = [(fl.states,)]
    step_s, _ = host_seconds(lambda: runs.append(step(runs[-1][0])), 2)
    counts = read_counts()
    peak_step = torch.cuda.max_memory_allocated()
    zero_launches("fleet", counts)
    runs = runs[1:]
    cfgb = solver.batched_config(fp.cfg)
    attempts_run = cfgb.max_iterations * (1 if cfgb.inner_attempts == 1 else 2)
    print(f"fleet ({smi_line}): {n} instances in chunks of {chunk}, N={fp.cfg.N}, "
          f"{fp.model.dtype}: {step_s * 1e3:.1f} ms per fleet step, {n / step_s:.2f} instance "
          f"steps/s (host clock, mean of the cold-start and the warm-start step after a "
          f"one-chunk warm-up of {warmup_s:.2f} s); peak memory {peak_step / 2**20:.1f} MiB over "
          f"both steps")
    for label, (st, u, d) in zip(("cold start", "warm start"), runs):
        if not bool(torch.isfinite(u).all()):
            fail(f"fleet {label}: non-finite controls for {int((~torch.isfinite(u)).any(1).sum())} "
                 f"instances")
        print(f"  {label}: solve_ok {int(d.solve_ok.sum())} of {n}, cost mean "
              f"{float(d.cost.mean()):.6f} max {float(d.cost.max()):.6f}, iterations "
              f"{torch.bincount(d.iterations).tolist()} (count per value), attempts needed "
              f"{int(d.attempts.sum())} of {attempts_run * n} run, has_prev "
              f"{int(st.has_prev.sum())}, t_idx {torch.bincount(st.t_idx).tolist()}")

    def gap_to_chunked(got, run):
        want = [getattr(run[0], f) for f in fleet_mod.STATE_FIELDS] + [run[1]] + list(run[2])
        got = [getattr(got[0], f) for f in fleet_mod.STATE_FIELDS] + [got[1]] + list(got[2])
        return max(float((g.double() - part(w).double()).abs().max()) for g, w in zip(got, want))

    # One chunk through fleet_step_once under sync-debug "error", on the warm step's inputs.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        one = once(runs[0][0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t1
    peak_chunk = torch.cuda.max_memory_allocated()
    gap = max(gap_to_chunked(warm, runs[0]), gap_to_chunked(one, runs[1]))
    print(f"  one chunk of {chunk} by fleet_step_once under sync debug mode 'error': no host sync; "
          f"{chunk_s * 1e3:.1f} ms; peak memory {peak_chunk / 2**20:.1f} MiB; max|once - chunked| "
          f"{gap:.3e} (the cold and the warm step's first chunk)")
    if gap != 0.0:
        fail(f"fleet: fleet_step_chunked's first chunk differs from fleet_step_once ({gap:.3e})")

    # Where a chunk's time goes: each part vmapped over the chunk, at the warm start's shapes.
    arrays = tuple(getattr(m0, f) for f in ARRAY_FIELDS)
    at = lambda a: m0.replace(**dict(zip(ARRAY_FIELDS, a)))
    win = extract_window(fp.refs, 1, fp.cfg.N)
    xb, ub, Kb = one[0].prev_xbar, one[0].prev_ubar, one[0].prev_K
    reg_t = torch.full((), fp.cfg.reg_init, device=dev)
    Ab, Bb = vmap(lambda a, x, u: solver.linearize(at(a), cfgb, x, u))(arrays, xb, ub)
    qb = vmap(lambda a, x, u: quadraticize_gn(at(a), fp.cp, win, x, u))(arrays, xb, ub)
    fl_alphas = torch.tensor(cfgb.alphas, device=dev)
    parts = breakdown({
        "linearize": lambda: vmap(lambda a, x, u: solver.linearize(at(a), cfgb, x, u))(
            arrays, xb, ub),
        "quadraticize_gn": lambda: vmap(lambda a, x, u: quadraticize_gn(at(a), fp.cp, win, x, u))(
            arrays, xb, ub),
        "trajectory_cost": lambda: vmap(lambda a, x, u: solver.trajectory_cost(at(a), fp.cp, win,
                                                                               x, u))(arrays, xb, ub),
        "rollout (open loop, masked)": lambda: vmap(
            lambda a, x, u: solver.rollout(at(a), cfgb, x, u))(arrays, x0s, ub),
        "line search (4 alphas, masked, with costs)": lambda: vmap(
            lambda a, x, xb_, ub_, K_: solver.rollout_alphas(at(a), fp.cp, cfgb, win, x, xb_, ub_,
                                                             K_, ub_ * 0.0, fl_alphas, "xla"))(
            arrays, x0s, xb, ub, Kb),
        "backward_pass": lambda: vmap(lambda A, B, q: solver.backward_pass(A, B, q, reg_t,
                                                                           cfgb.pd_bump))(Ab, Bb, qb),
    }, f"fleet chunk of {chunk}, N={fp.cfg.N}", reps=1)
    trips, att = cfgb.max_iterations, attempts_run
    est = (trips * (parts["linearize"] + parts["quadraticize_gn"])
           + (1 + trips) * parts["trajectory_cost"] + 2 * parts["rollout (open loop, masked)"]
           + att * (parts["backward_pass"] + parts["line search (4 alphas, masked, with costs)"]))
    print(f"  per chunk: {trips} x (linearize + quadraticize_gn), {1 + trips} x trajectory_cost, "
          f"2 x rollout, {att} x (backward_pass + line search) = {est:.1f} ms of the "
          f"{step_s * 1e3 / (n // chunk):.1f} ms a chunk takes in the fleet step")


def main() -> int:
    import numpy as np
    import torch

    # ---- 1. device ---------------------------------------------------------
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a GPU only")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode:
        fail(f"nvidia-smi failed: {smi.stderr}")
    print(f"device: {kind} (count {count}), torch {torch.__version__}, CUDA {torch.version.cuda}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line)
    phase("device", t0)

    sys.path.insert(0, ROOT)
    from mpc_ilqr_tpu_torch import scenarios
    from mpc_ilqr_tpu_torch.costs.quadratics import (CostQuadratics, quadraticize_gn,
                                                     trajectory_costs)
    from mpc_ilqr_tpu_torch.costs.references import extract_window
    from mpc_ilqr_tpu_torch.ilqr import solver
    from mpc_ilqr_tpu_torch.models.robot import load_h1, standing_state
    from mpc_ilqr_tpu_torch.mpc import controller
    from mpc_ilqr_tpu_torch.ops import _build
    from mpc_ilqr_tpu_torch.ops import riccati
    from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk
    from mpc_ilqr_tpu_torch.ops.step_plan import build_step_plan, model_bytes

    def reset_counts():
        rk.reset_launch_counts()
        riccati.reset_launch_counts()

    def read_counts():
        torch.cuda.synchronize()
        return {**rk.LAUNCHES, **riccati.LAUNCHES}

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"nvcc build: {_build.build_log['seconds']:.2f} s -> {_build.build_log['path']}")
    for line in _build.build_log["ptxas"]:
        print(f"  {line}")
    phase("build", t0)

    # ---- 3. kernels against their plain versions ---------------------------
    t0 = time.perf_counter()
    prob = standing_problem()  # device "cuda", float32
    model, cp, cfg, refs, plan = prob.model, prob.cp, prob.cfg, prob.refs, prob.plan
    if plan is None or model.device.type != "cuda":
        fail("setup did not place the problem and its kernel plan on the card")
    N, nx, nu, dev = cfg.N, model.nx, model.nu, model.device
    smem = lib.mpc_smem_bytes(plan.fbuf.numel(), plan.ibuf.numel(), plan.B, plan.nq, plan.nv,
                              plan.nu, plan.ncp)
    print(f"shared memory per block (H1): {smem} bytes; packed plan "
          f"{4 * (plan.fbuf.numel() + plan.ibuf.numel())} bytes, of them the model "
          f"{model_bytes(plan)} bytes")
    tpu_id = {"rollout": "K1", "linesearch": "K2", "linesearch_batched": "K3"}
    replaces = {"rollout": "mpc_ilqr_tpu/ops/rollout_kernel.py:61",
                "linesearch": "mpc_ilqr_tpu/ops/rollout_kernel.py:108",
                "linesearch_batched": "mpc_ilqr_tpu/ops/rollout_kernel.py:208"}

    def kernel_cases(m, p, N=N):
        """(kernel, plain, A, feedback) per entry point at the main path's
        shapes (H1, N=25 unless given; A=1 and the 7 fallback alphas)."""
        i = kernel_inputs(m, cfg.alphas, N)
        x0, us_grav, a1, a7 = i["x0"], i["us"], i["a1"], i["a7"]
        ls = (x0, i["xbar"], i["ubar"], i["K"], i["kff"])
        # The plain versions take (model, dtype) so they also run in float64.
        cast = lambda dt, *ts: [t.to(dt) for t in ts]
        return {
            "rollout": (lambda: rk.rollout_kernel(m, p, x0, us_grav),
                        lambda mm=m, dt=torch.float32: rk.rollout_plain(
                            mm, *cast(dt, x0, us_grav)), 1, False),
            "linesearch": (lambda: rk.linesearch_rollout_kernel(m, p, *ls, a1),
                           lambda mm=m, dt=torch.float32: rk.linesearch_rollout_plain(
                               mm, *cast(dt, *ls, a1)), 1, True),
            "linesearch_batched": (
                lambda: rk.linesearch_rollout_kernel_batched(m, p, *ls, a7),
                lambda mm=m, dt=torch.float32: rk.linesearch_rollout_batched_plain(
                    mm, *cast(dt, *ls, a7)), 7, True),
        }

    def max_err(a, b):
        a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
        for g, w in zip(a, b):
            if g.shape != w.shape:
                fail(f"kernel output shape {tuple(g.shape)} != plain {tuple(w.shape)}")
            if not torch.isfinite(g).all():
                fail("kernel output is not finite")
        return max(float((g.double() - w.double()).abs().max()) for g, w in zip(a, b))

    # (a) The reference's own kernel-test model (load_h1 defaults, tests/test_ops.py:148-215)
    #     at the main path's shapes: kernel vs plain float32, atol 2e-4.
    ref_model = load_h1(gravity=(0.0, 0.0, -1.0), timestep=0.02)
    ref_cases = kernel_cases(ref_model, build_step_plan(ref_model))
    # (b) The main path's model (config.yaml: stiffness 5000, damping 300, impratio 100).
    #     Its stiff stiction makes the 25-step float32 chain part from float64 by ~1e-3
    #     in any float32 implementation (tools/port_f32_floor.py: the JAX package's own
    #     Pallas kernel and XLA rollout differ by 1.2e-3 there), so the kernel is held to
    #     float64 instead: |kernel - plain64| <= 2e-4 + 2 |plain32 - plain64|.
    main_cases = kernel_cases(model, plan)
    # (c) The main path's model where its impratio matters: two steps from the standing
    #     state, all 8 contact points down and |v_t| at 0 then ~2e-5, below the stiction
    #     regularisation's sqrt(1e-6 / impratio) = 1e-4. Round-off has not grown yet
    #     (plain float32 is within about 5e-5 of float64 here, tools/port_f32_floor.py),
    #     so the kernel is held to float64 at atol 2e-4.
    stiction_cases = kernel_cases(model, plan, 2)
    model64, ref_model64 = model.to(dtype=torch.float64), ref_model.to(dtype=torch.float64)
    report = {}
    for name in ref_cases:
        kern, plain, _, _ = ref_cases[name]
        got, p32, p64 = kern(), plain(), plain(ref_model64, torch.float64)
        err, r_k, r_p = max_err(got, p32), max_err(got, p64), max_err(p32, p64)
        print(f"{tpu_id[name]} {rk.CUDA_KERNEL[name]} (reference test model): "
              f"max|kernel - plain| = {err:.3e} (atol {ATOL}); diagnostic: |kernel-plain64| "
              f"{r_k:.3e}, |plain32-plain64| {r_p:.3e}")
        if not err <= ATOL:
            fail(f"{name}: kernel disagrees with its plain version ({err:.3e} > {ATOL})")
        kern, plain, _, _ = stiction_cases[name]
        e_s = max_err(kern(), plain(model64, torch.float64))
        print(f"  main-path model, 2 steps from standing: |kernel-plain64| {e_s:.3e} (atol {ATOL})")
        if not e_s <= ATOL:
            fail(f"{name}: kernel disagrees with float64 in the stiction regime ({e_s:.3e} > {ATOL})")
        kern, plain, A, feedback = main_cases[name]
        got, p32, p64 = kern(), plain(), plain(model64, torch.float64)
        e_k, e_p, e_kp = max_err(got, p64), max_err(p32, p64), max_err(got, p32)
        bar = ATOL + 2.0 * e_p
        print(f"  main-path model: |kernel-plain64| {e_k:.3e}, |plain32-plain64| {e_p:.3e}, "
              f"|kernel-plain32| {e_kp:.3e} (bar {bar:.3e})")
        if not e_k <= bar:
            fail(f"{name}: kernel further from float64 than float32 allows ({e_k:.3e} > {bar:.3e})")
        torch.cuda.synchronize()
        ms = event_ms(kern, 50)
        plain_ms = event_ms(plain, 3)
        if feedback:
            n_in = nx + (N + 1) * nx + N * nu + N * nu * nx + N * nu + A
            n_out = A * ((N + 1) * nx + N * nu)
        else:
            n_in, n_out = nx + N * nu, (N + 1) * nx
        flops = chain_flops(model, got[0][:, :-1] if feedback else got[:-1], feedback)
        n_bytes = 4 * (n_in + n_out) + model_bytes(plan)
        bound_ms, bound_by = bound(n_bytes, flops)
        print(f"  {ms:.4f} ms/launch (plain {plain_ms:.3f} ms; bound {bound_ms:.6f} ms by "
              f"{bound_by}: {n_bytes} bytes, {flops} flop)")
        report[name] = dict(name=f"{tpu_id[name]} {rk.CUDA_KERNEL[name]}", route="cuda",
                            source="mpc_ilqr_tpu_torch/csrc/rollout.cu",
                            replaces=replaces[name], launches=0, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=None, bytes=n_bytes, flops=flops,
                            ref_model_err_vs_f64=r_k, ref_model_plain32_err_vs_f64=r_p,
                            stiction_err_vs_f64=e_s, main_model_err_vs_f64=e_k,
                            main_model_plain32_err_vs_f64=e_p)
    phase("kernels", t0)
    if "--kernels" in sys.argv[1:]:
        return 0

    # ---- 4. the closed loop ------------------------------------------------
    t0 = time.perf_counter()
    x_init = standing_state(model)
    reset_counts()
    _, xT, hist = controller.run_closed_loop(model, cp, cfg, refs, controller.init_state(model, cfg),
                                             x_init, N_STEPS, plan=plan)
    launches = read_counts()
    loop_s = time.perf_counter() - t0
    costs = hist["cost"].cpu().numpy()
    xs = hist["x"].cpu().numpy()
    for i in range(N_STEPS):
        print(f"step {i:2d}: cost {costs[i]:.6f}  iterations {hist['iterations'][i]}  "
              f"solve_ok {hist['solve_ok'][i]}  base_z {xs[i, 2]:.6f}")
    base_z = float(xT[2])
    print(f"final base_z {base_z:.6f}; launches {launches}; first run {loop_s:.2f} s")
    print(ANCHORS)
    if not (np.isfinite(xs).all() and bool(torch.isfinite(xT).all())):
        fail("non-finite state in the closed loop")
    if not all(hist["solve_ok"]):
        fail(f"solve_ok false at steps {[i for i, ok in enumerate(hist['solve_ok']) if not ok]}")
    if not (1.0 < xs[:, 2].min() and xs[:, 2].max() < 1.1 and 1.0 < base_z < 1.1):
        fail(f"base_z left (1.0, 1.1): min {xs[:, 2].min()}, max {xs[:, 2].max()}, final {base_z}")
    if not costs[-1] < costs[0]:
        fail(f"last cost {costs[-1]} is not below the first {costs[0]}")
    for name in ("rollout", "linesearch"):
        if launches[name] < 1:
            fail(f"{tpu_id[name]} was not launched on the main path")
    for name in report:
        report[name]["launches"] = launches[name]
        report[name]["launches_by_path"] = {"standing": launches[name]}

    t1 = time.perf_counter()
    controller.run_closed_loop(model, cp, cfg, refs, controller.init_state(model, cfg), x_init,
                               N_STEPS, plan=plan)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) * 1e3 / N_STEPS
    print(f"closed loop: {step_ms:.2f} ms per MPC step (host clock, warm, {N_STEPS} steps)")

    # Where one solver iteration's time goes, at the last step's window.
    win = extract_window(refs, N_STEPS - 1, N)
    x_last, ub = hist["x"][-1], hist["u"][-1][None].repeat(N, 1).contiguous()
    xb = rk.rollout_kernel(model, plan, x_last, ub)
    A_, B_ = solver.linearize(model, cfg, xb, ub)
    quad = quadraticize_gn(model, cp, win, xb, ub)
    Kf, kf = solver.backward_pass(A_, B_, quad, torch.tensor(1e-6, device=dev), cfg.pd_bump)
    al = torch.tensor(cfg.alphas, device=dev)
    parts = {
        "linearize (step_and_jac, vmapped)": lambda: solver.linearize(model, cfg, xb, ub),
        "quadraticize_gn": lambda: quadraticize_gn(model, cp, win, xb, ub),
        "backward_pass": lambda: solver.backward_pass(A_, B_, quad, torch.tensor(1e-6, device=dev),
                                                      cfg.pd_bump),
        "trajectory_costs (1 candidate)": lambda: trajectory_costs(model, cp, win, xb[None], ub[None]),
        "K1 rollout_kernel": lambda: rk.rollout_kernel(model, plan, x_last, ub),
        "K2 linesearch (A=1)": lambda: rk.linesearch_rollout_kernel(
            model, plan, x_last, xb, ub, Kf, kf, al[:1]),
        "K3 linesearch_batched (A=7)": lambda: rk.linesearch_rollout_kernel_batched(
            model, plan, x_last, xb, ub, Kf, kf, al[1:]),
    }
    breakdown(parts, f"N={N}")
    phase("loop", t0)

    # ---- 5. K4 against its plain version -----------------------------------
    t0 = time.perf_counter()
    print(f"K4 shared memory per block (H1, nx={nx}, nu={nu}): "
          f"{lib.mpc_riccati_smem_bytes(nx, nu)} bytes")

    def riccati_err(label, got, want):
        """max |kernel - plain| where the plain version is finite, after
        checking the kernel is finite exactly where it is and within
        atol + rtol |plain| everywhere else."""
        err = 0.0
        for g, w in zip(got, want):
            if g.shape != w.shape:
                fail(f"{label}: K4 output shape {tuple(g.shape)} != plain {tuple(w.shape)}")
            if not torch.equal(torch.isfinite(g), torch.isfinite(w)):
                fail(f"{label}: K4 is not finite exactly where its plain version is not")
            fin = torch.isfinite(w)
            d, ref = (g - w).abs()[fin].double(), w.abs()[fin].double()
            if bool((d > RICCATI_ATOL + RICCATI_RTOL * ref).any()):
                fail(f"{label}: K4 disagrees with its plain version beyond rtol {RICCATI_RTOL}, "
                     f"atol {RICCATI_ATOL} (max {float(d.max()):.3e})")
            err = max(err, float(d.max()) if d.numel() else 0.0)
        return err

    k4_err = 0.0
    for N_, nx_, nu_, case, reg_ in RICCATI_CASES:
        args = [torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in riccati_problem(N_, nx_, nu_, case)]
        got = riccati.backward_pass_kernel(*args, reg_, cfg.pd_bump)
        want = riccati.backward_pass_plain(*args, reg_, cfg.pd_bump)
        e = riccati_err(f"K4 ({N_}, {nx_}, {nu_}) {case}", got, want)
        if case == "rescued" and not bool(torch.isfinite(got[1][RICCATI_T_BAD]).all()):
            fail("K4: the PD bump did not rescue the zero pivot")
        k4_err = max(k4_err, e)
        print(f"K4 riccati_backward ({N_}, {nx_}, {nu_}) {case}: max|kernel - plain| = {e:.3e} "
              f"(first design: {FIRST_K4[(N_, nx_, nu_, case)]:.3e}; rtol {RICCATI_RTOL}, atol "
              f"{RICCATI_ATOL}; non-finite at {int((~torch.isfinite(got[1])).any(1).sum())} of "
              f"{N_} steps, as plain)")

    # The long-horizon path's own inputs: A, B and the GN quadratics at N=100 along the
    # cold-start rollout from standing. The value function there is conditioned like the
    # flagship's contact chain, so two float32 recursions part by more than 2e-4; the
    # kernel is held to float64 no further than float32 allows.
    li = long_horizon_inputs()
    lh, lx0, lub, lxb, lwin, A_, B_, lq = (li[k] for k in ("prob", "x0", "us", "xs", "window",
                                                            "A", "B", "quad"))
    lm, lcfg, lh_args = lh.model, lh.cfg, li["args"]
    reg_t, pd = torch.tensor(lcfg.reg_init, device=dev), lcfg.pd_bump
    got = riccati.backward_pass_kernel(*lh_args, reg_t, pd)
    p32 = riccati.backward_pass_plain(*lh_args, reg_t, pd)
    a64 = [t.double() for t in lh_args]
    bump_steps = []  # the work this data needs: the steps where the bump fires
    p64 = riccati.backward_pass_plain(*a64, lcfg.reg_init, pd, bumps=bump_steps)
    # K (|K| up to ~1e3) and kff have float32 floors far apart, so each is held to its own bar.
    lh_err = {}
    for j, out in enumerate(("K", "kff")):
        e_k, e_p, e_kp = max_err(got[j], p64[j]), max_err(p32[j], p64[j]), max_err(got[j], p32[j])
        bar = RICCATI_ATOL + 2.0 * e_p
        lh_err[out] = (e_k, e_p)
        print(f"K4 on the long-horizon inputs (N={lcfg.N}), {out}: |kernel-plain64| {e_k:.3e} "
              f"(first design: {FIRST_K4[out]:.3e}), |plain32-plain64| {e_p:.3e}, "
              f"|kernel-plain32| {e_kp:.3e} (bar {bar:.3e}); max |{out}| "
              f"{float(p64[j].abs().max()):.3e}")
        if not e_k <= bar:
            fail(f"K4 {out} further from float64 than float32 allows ({e_k:.3e} > {bar:.3e})")
    print(f"  PD bumps on these inputs: at steps {sorted(bump_steps)}")

    k4 = {}
    for Nt in (25, lcfg.N):
        s0 = lcfg.N - Nt
        a = [t[s0:].contiguous() for t in lh_args]
        quad_t = CostQuadratics(*a[2:])
        ms = event_ms(lambda: riccati.backward_pass_kernel(*a, reg_t, pd), 20)
        plain_ms = event_ms(lambda: riccati.backward_pass_plain(*a, reg_t, pd), 2)
        loop_ms = event_ms(lambda: solver.backward_pass(a[0], a[1], quad_t, reg_t, pd), 3)
        n_bumps = sum(t >= s0 for t in bump_steps)
        n_bytes, flops = riccati_bytes(Nt, nx, nu), riccati_flops(Nt, nx, nu, n_bumps)
        bound_ms, bound_by = bound(n_bytes, flops)
        k4[Nt] = dict(ms=ms, plain_ms=plain_ms, loop_ms=loop_ms, bound_ms=bound_ms,
                      bound_by=bound_by, bytes=n_bytes, flops=flops)
        print(f"  N={Nt}: K4 {ms:.4f} ms/launch (plain {plain_ms:.3f} ms; port loop "
              f"solver.backward_pass {loop_ms:.3f} ms; bound {bound_ms:.6f} ms by {bound_by}: "
              f"{n_bytes} bytes, {flops} flop)")
    report["riccati"] = dict(
        name="K4 riccati_backward", route="cuda", source="mpc_ilqr_tpu_torch/csrc/riccati.cu",
        replaces="mpc_ilqr_tpu/ops/riccati.py:143", launches=0, max_abs_err=k4_err,
        ms=k4[lcfg.N]["ms"], plain_ms=k4[lcfg.N]["plain_ms"], bound_ms=k4[lcfg.N]["bound_ms"],
        bound_by=k4[lcfg.N]["bound_by"], library_ms=None, bytes=k4[lcfg.N]["bytes"],
        flops=k4[lcfg.N]["flops"], port_loop_ms=k4[lcfg.N]["loop_ms"], ms_n25=k4[25]["ms"],
        plain_ms_n25=k4[25]["plain_ms"], port_loop_ms_n25=k4[25]["loop_ms"],
        bound_ms_n25=k4[25]["bound_ms"], main_path_K_err_vs_f64=lh_err["K"][0],
        main_path_K_plain32_err_vs_f64=lh_err["K"][1], main_path_kff_err_vs_f64=lh_err["kff"][0],
        main_path_kff_plain32_err_vs_f64=lh_err["kff"][1],
        launches_by_path={"standing": launches["riccati"]})
    phase("riccati", t0)

    # ---- 6. the long-horizon path --------------------------------------------
    t0 = time.perf_counter()

    def drive(prob_, solve_every, n_steps):
        x0 = standing_state(prob_.model)
        state0 = controller.init_state(prob_.model, prob_.cfg)
        if solve_every == 1:
            return controller.run_closed_loop(prob_.model, prob_.cp, prob_.cfg, prob_.refs,
                                              state0, x0, n_steps, plan=prob_.plan)
        return scenarios.tvlqr_amortized_loop(prob_, solve_every, state0, x0, n_steps)

    variants = {"long_horizon_tuned": dict(tuned=True),
                "long_horizon_tuned_it1_tvlqr2": dict(tuned=True, iters=1, solve_every=2)}
    for label, kw in variants.items():
        prob_, n_steps = scenarios.long_horizon(**kw)
        k = kw.get("solve_every", 1)
        t1 = time.perf_counter()
        reset_counts()
        _, xT_, h = drive(prob_, k, n_steps)
        counts = read_counts()
        first_s = time.perf_counter() - t1
        xs_ = h["x"].cpu().numpy()
        costs_ = h["cost"].cpu().numpy()
        for i in range(len(costs_)):
            print(f"{label} solve {i}: cost {costs_[i]:.6f}  iterations {h['iterations'][i]}  "
                  f"solve_ok {h['solve_ok'][i]}  base_z {xs_[i * k, 2]:.6f}")
        z_ = float(xT_[2])
        print(f"{label}: {n_steps} control steps, N={prob_.cfg.N}, final base_z {z_:.6f}, final "
              f"cost {costs_[-1]:.6f}; launches {counts}; first run {first_s:.2f} s")
        if not (np.isfinite(xs_).all() and bool(torch.isfinite(xT_).all())):
            fail(f"{label}: non-finite state")
        if not all(h["solve_ok"]):
            fail(f"{label}: solve_ok false at solves "
                 f"{[i for i, ok in enumerate(h['solve_ok']) if not ok]}")
        if not (1.0 < xs_[:, 2].min() and xs_[:, 2].max() < 1.1 and 1.0 < z_ < 1.1):
            fail(f"{label}: base_z left (1.0, 1.1): min {xs_[:, 2].min()}, max "
                 f"{xs_[:, 2].max()}, final {z_}")
        if k > 1 and not costs_[-1] < costs_[0]:
            fail(f"{label}: last cost {costs_[-1]} is not below the first {costs_[0]}")
        n_it = sum(h["iterations"])
        attempts = 1 if prob_.cfg.inner_attempts == 1 else 2
        print(f"  backward passes: K4 launches {counts['riccati']}, iterations {n_it}, "
              f"attempts per iteration <= {attempts}")
        if not (1 <= n_it <= counts["riccati"] <= attempts * n_it):
            fail(f"{label}: K4 launches {counts['riccati']} do not match {n_it} iterations")
        for name in ("rollout", "linesearch"):
            if counts[name] < 1:
                fail(f"{label}: {tpu_id[name]} was not launched")
        for name in report:
            report[name]["launches_by_path"][label] = counts[name]
        report["riccati"]["launches"] += counts["riccati"]
        t1 = time.perf_counter()
        drive(prob_, k, n_steps)
        torch.cuda.synchronize()
        print(f"{label}: {(time.perf_counter() - t1) * 1e3 / n_steps:.2f} ms per control step "
              f"(host clock, warm, {n_steps} steps)")
    print(LH_ANCHORS)

    # Where one solver iteration's time goes at N=100, on phase 5's inputs.
    Kf, kf = riccati.backward_pass_kernel(*lh_args, reg_t, pd)
    al = torch.tensor(lcfg.alphas, device=dev)
    breakdown({
        "linearize (step_and_jac, vmapped)": lambda: solver.linearize(lm, lcfg, lxb, lub),
        "quadraticize_gn": lambda: quadraticize_gn(lm, lh.cp, lwin, lxb, lub),
        "backward_pass (port loop)": lambda: solver.backward_pass(A_, B_, lq, reg_t, pd),
        "K4 riccati_backward": lambda: riccati.backward_pass_kernel(*lh_args, reg_t, pd),
        "trajectory_costs (1 candidate)": lambda: trajectory_costs(lm, lh.cp, lwin, lxb[None],
                                                                   lub[None]),
        "K1 rollout_kernel": lambda: rk.rollout_kernel(lm, lh.plan, lx0, lub),
        "K2 linesearch (A=1)": lambda: rk.linesearch_rollout_kernel(
            lm, lh.plan, lx0, lxb, lub, Kf, kf, al[:1]),
        "K3 linesearch_batched (A=7)": lambda: rk.linesearch_rollout_kernel_batched(
            lm, lh.plan, lx0, lxb, lub, Kf, kf, al[1:]),
    }, f"N={lcfg.N}")
    phase("long horizon", t0)

    # ---- 7. walking through the system's entry point ----------------------------
    t0 = time.perf_counter()
    from mpc_ilqr_tpu_torch.io import logging as iolog
    from mpc_ilqr_tpu_torch.io import native
    from mpc_ilqr_tpu_torch.io.config import load_config
    from mpc_ilqr_tpu_torch.mpc import runner
    from mpc_ilqr_tpu_torch.utils.profiling import Profiler

    app = load_config(os.path.join(ROOT, "config.yaml"))  # nothing swapped: walking
    wprob = runner.setup(app)
    wm, steps = wprob.model, app.mpc.sim_steps
    print(f"walking: {app.q_ref_path}, {app.v_ref_path}, {app.contact_schedule_path}; "
          f"{wprob.refs.length} reference rows, N={wprob.cfg.N}, {steps} sim steps, "
          f"device {wm.device}, {wm.dtype}")
    if wprob.plan is None or wm.device.type != "cuda":
        fail("walking: setup did not place the problem and its kernel plan on the card")
    log_dir = os.path.join(ROOT, "logs", "chip_smoke_walking")
    step_logger = iolog.StepLogger(os.path.join(log_dir, "mpc_log.csv"), wm.nx, wm.nu)
    traj_logger = iolog.OptimalTrajectoryLogger(os.path.join(log_dir, "results"), wm.nq, wm.nu)
    if not step_logger.native:
        fail(f"walking: the native log writer is not in use ({native.build_error})")
    prof, oks = Profiler(), []
    reset_counts()
    wait, runner.block_until_ready = runner.block_until_ready, recording_waits(runner, oks)
    try:
        t1 = time.perf_counter()
        whist, _ = runner.run_simulation(wprob, verbose=False, profiler=prof,
                                         step_logger=step_logger, traj_logger=traj_logger)
        run_s = time.perf_counter() - t1
    finally:
        runner.block_until_ready = wait
    counts = read_counts()
    n_run = len(whist["cost"])
    failed = [i for i, ok in enumerate(oks) if not ok]
    aborted = any(i > 15 for i in failed)
    q = walking_quality(os.path.join(log_dir, "mpc_log.csv"))
    wx = np.stack(whist["x"])
    ms_step = run_s * 1e3 / n_run
    for i in range(n_run):
        print(f"walking step {i:3d}: cost {whist['cost'][i]:.4f}  iterations "
              f"{whist['iterations'][i]}  solve_ok {oks[i]}  base xyz ({wx[i, 0]:.6f}, "
              f"{wx[i, 1]:.6f}, {wx[i, 2]:.6f})  solve {whist['solve_ms'][i]:.2f} ms")
    print(f"walking ({smi_line}): {n_run} of {steps} steps run, solve_ok {n_run - len(failed)} "
          f"of {n_run} (failed at {failed}; abort {aborted}); final cost {q['final_cost']:.4f}, "
          f"final base z {q['base_z']:.6f}, base z in [{q['z_min']:.6f}, {q['z_max']:.6f}]")
    print(f"walking tracking |x - x_ref| ({smi_line}): base X/Y/Z mean "
          f"{q['mean_err'][0]:.6f}/{q['mean_err'][1]:.6f}/{q['mean_err'][2]:.6f}, max "
          f"{q['max_err'][0]:.6f}/{q['max_err'][1]:.6f}/{q['max_err'][2]:.6f}")
    print(f"walking ({smi_line}): {ms_step:.2f} ms per MPC step (host clock, warm, {n_run} steps, "
          f"run_simulation with logs and plant); steady solve "
          f"{sum(whist['solve_ms'][1:]) / max(1, n_run - 1):.2f} ms; launches {counts}")
    print(f"JAX package's walking run, CPU float32 (information; the gate's anchor): "
          f"{WALK_ANCHOR['steps_run']} steps run, failed at {list(WALK_ANCHOR['failed'])}, final "
          f"cost {WALK_ANCHOR['final_cost']}, base z {WALK_ANCHOR['base_z']}, tracking mean "
          f"{WALK_ANCHOR['mean_err']}, max {WALK_ANCHOR['max_err']}")
    print(prof.report())
    if not (np.isfinite(wx).all() and all(np.isfinite(u).all() for u in whist["u"])):
        fail("walking: non-finite state or control")
    if n_run < steps and not aborted:
        fail(f"walking: stopped after {n_run} of {steps} steps without a solve-failure abort "
             f"(a non-finite state)")
    if len(failed) > len(WALK_ANCHOR["failed"]) or (
            aborted and n_run < WALK_ANCHOR["steps_run"]):
        fail(f"walking: solves failed at {failed} (abort after {n_run} steps); the JAX package's "
             f"run failed at {list(WALK_ANCHOR['failed'])} and ran {WALK_ANCHOR['steps_run']}")
    if not (1.0 < wx[:, 2].min() and wx[:, 2].max() < 1.1):
        fail(f"walking: base_z left (1.0, 1.1): min {wx[:, 2].min()}, max {wx[:, 2].max()}")
    if step_logger.dropped != 0:
        fail(f"walking: the log writer dropped {step_logger.dropped} rows")
    with open(os.path.join(log_dir, "mpc_log.csv")) as f:
        n_lines = sum(1 for _ in f)
    if n_lines != 1 + n_run or q["header"] != step_logger.header:
        fail(f"walking: step log has {n_lines} lines for {n_run} steps, or another header")
    for name in ("rollout", "linesearch"):
        if counts[name] < 1:
            fail(f"walking: {tpu_id[name]} was not launched")
    for name in report:
        report[name]["launches_by_path"]["walking"] = counts[name]

    t1 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "mpc_ilqr_tpu_torch.run_mpc", "--standing",
                          "--steps", "3", "--quiet", "--profile"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    print(f"CLI `python -m mpc_ilqr_tpu_torch.run_mpc --standing --steps 3 --quiet --profile`: "
          f"exit {cli.returncode} in {time.perf_counter() - t1:.1f} s")
    for line in cli.stdout.splitlines():
        print(f"  | {line}")
    if cli.returncode != 0 or "device: cuda" not in cli.stdout:
        fail(f"the CLI did not run on cuda (exit {cli.returncode}):\n{cli.stderr[-4000:]}")
    phase("walking", t0)

    # ---- 8. batched: the 16-alpha x 8-seed search and the 1024-instance fleet ----
    t0 = time.perf_counter()
    batched_phase(report, smi_line, reset_counts, read_counts)
    phase("batched", t0)

    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    faulthandler.dump_traceback_later(900, exit=True)  # a hang becomes a failing exit
    sys.stdout.reconfigure(line_buffering=True)
    t_start = time.perf_counter()
    rc = main()
    print(f"[phase] total: {time.perf_counter() - t_start:.3f} s", file=sys.stderr)
    sys.exit(rc)
