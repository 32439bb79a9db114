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
              allows; then timed at N=25 and N=100 beside the plain version
              and the port's torch.linalg loop
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
  9. exact    (a) scenarios.exact_standing: the standing flagship on the
              reference's own derivative model (linearization "ad",
              quad_mode "exact"), 15 MPC steps of run_closed_loop in
              float32 with K1-K3, held to the gates of phase 4; ms and
              iterations per step, one iteration's linearize and
              quadraticize beside the flagship's, the peak memory, and the
              JAX package's own run of the same steps (EXACT_ANCHOR).
              (b) every other new mode once on H1 at N=25 in float64, at
              one nominal (standing, gravity compensation plus seeded
              noise): "ad_frozen_mass" against "ad"; "fd" against "ad" in
              the JAX test's own setting (load_h1's contact, standing at
              gravity compensation, N=3, fd_eps 1e-6) and, at N=25, its
              truncation error shrinking tenfold with fd_eps;
              lin_chunk 16 against full width (ad, structured,
              structured_frozen_mass),
              hess_chunk 16 against full width, GN against exact, and
              trajectory_cost(mode="full") against the sum of its terms,
              each at the JAX test's bar (EXACT_BARS); then one float32
              solve with cost_mode "full", held to success, a finite cost
              and a decrease
 10. shards   (a) a world-1 NCCL process group and make_mesh(1) (dp = ls = 1):
              step_once_sharded for 15 MPC steps of the standing flagship
              with first_accept and ls_backend pallas_batched (K3 over the
              shard's alphas, K1 for the nominal), held to the local
              step_once with the same config to the last bit (iterations,
              solve_ok, costs, controls, states) and to phase 4's gates;
              (b) shard_fleet_step on one chunk of 128 instances of
              scenarios.fleet, held to fleet_step_once on the same chunk
              (controls equal, the mean cost and the solve_ok count equal);
              (c) long horizon (a) with backward "assoc", 5 steps, held to
              phase 6's gates with no K4 launch; ms per control step beside
              phase 6's; backward_pass_assoc ms per call beside K4 and the
              backward_pass loop; its K and kff against the float64 serial
              pass: in float64 on tests/test_ops.py:64-86's 12x5, N=100
              problem at rtol 1e-8 / atol 1e-9, and in float32 on phase 5's
              long-horizon inputs, no further than ASSOC_FACTOR times the
              JAX package's own float32 pass on them (ASSOC_ANCHOR); (d)
              quat_frames against forward_kinematics on H1 and H1 with
              hands, float64, at the JAX test's bar (atol 1e-12, rtol 1e-7);
              then the group is destroyed
 11. k4 at every input  (a) K4 against its plain version on the random
              cases past the narrow design's sizes (RICCATI_CASES: H1 with
              hands (103, 45) plain and both bump cases, (128, 64), and the
              wide design's limit (160, 80) with both bump cases), at the JAX
              bar, after each wide size's cluster, shared memory per CTA,
              scratch (none) and resident clusters are printed; (b) on the
              hands problem's own inputs
              (hands_inputs: A, B and the GN quadratics along the cold-start
              rollout) at N=25 and N=100 against float64, no further than
              float32 allows; (c) the hands solve (hands_problem: config.yaml's
              solver with backward "pallas") at N=25, dt 0.02 and N=100, dt
              0.01, held to finite outputs, the iterations and solve_ok of
              the same solve with backward "scan", its final cost within
              SEED_COST_RTOL, K4 once per backward pass and K1/K2 launched;
              ms per iteration and where a hands iteration's time goes;
              (d) one fleet chunk of 128 through fleet_step_once with
              backward "pallas" under sync-debug "error" and the 8-seed
              search with "pallas", each against phase 8's "scan" run of the
              same problem (solve_ok count equal, controls within
              SEED_UBAR_ATOL, costs within SEED_COST_RTOL), K4 launched once
              per attempt run with the whole batch in one launch; (e) K4's
              times at the hands sizes and over the chunk's 128 instances
              (B=128, H1, N=25) beside the plain version and the port's loop
              (vmapped for the batch)
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
# K4's reference cases: (N, nx, nu, riccati_problem case, λ). Phase 5 runs those at
# nx <= 64, nu <= 32 (riccati_backward, the narrow design); phase 11 the others: H1
# with hands (103, 45), its bump cases (N=8: one step past the bad one), (128, 64) and
# the wide design's limit (160, 80) with its bump cases.
RICCATI_CASES = ((10, 51, 19, "plain", 1e-6), (4, 13, 5, "plain", 1e-5),
                 (10, 51, 19, "rescued", RICCATI_REG), (10, 51, 19, "indefinite", RICCATI_REG),
                 (3, 103, 45, "plain", 1e-6), (8, 103, 45, "rescued", RICCATI_REG),
                 (8, 103, 45, "indefinite", RICCATI_REG), (3, 128, 64, "plain", 1e-6),
                 (3, 160, 80, "plain", 1e-6), (8, 160, 80, "rescued", RICCATI_REG),
                 (8, 160, 80, "indefinite", RICCATI_REG))
# H1 with dexterous hands (nq=52, nv=51: nx=103, nu=45), the second model the repo
# ships; phase 11 solves it with config.yaml's solver (hands_problem).
HANDS_XML = os.path.join("robots", "h1_description", "mjcf", "h1_with_hand.xml")
HANDS_EE = ("left_ankle_link", "right_ankle_link")
HANDS_SIZES = ((25, 0.02), (100, 0.01))  # (N, dt): the flagship's and the long horizon's
# Phase 8's bars on the batched seed solve against the same device-side solve run on
# one seed at a time (float32: batched and single products round differently).
SEED_COST_RTOL, SEED_UBAR_ATOL = 1e-4, 3e-3
# The JAX package's own run of phase 9 (a) (config.yaml with the standing references,
# linearization "ad", quad_mode "exact", 15 MPC steps of run_closed_loop, float32, on
# the CPU; tools/exact_anchor.py). Information only: the float32 floor applies.
EXACT_ANCHOR = dict(steps=15, solve_ok=15, first_cost=1.093064, final_cost=0.400029,
                    base_z=1.04269, iterations_per_step=1.2)
# Phase 9 (b)'s bars (low, high), float64: tests/test_linearize_fd.py:23-24 (fd against
# ad, in that test's setting, N=3), :45-47 (frozen mass), :132-136 (lin_chunk against full
# width); tests/test_costs.py:194-198 (hess_chunk) and :254-256 (GN against exact);
# 0.0 means equal to the last bit. A truncation error ∝ fd_eps shrinks tenfold with it.
EXACT_BARS = {"fd vs ad": (0.0, 5e-4), "fd truncation, gap(1e-6) / gap(1e-7)": (8.0, 12.0),
              "ad_frozen_mass vs ad, B": (0.0, 1e-9), "ad_frozen_mass vs ad, A": (0.0, 0.05),
              "lin_chunk 16 (ad)": (0.0, 1e-8), "lin_chunk 16 (structured)": (0.0, 1e-8),
              "lin_chunk 16 (structured_frozen_mass)": (0.0, 1e-8),
              "hess_chunk 16, lxx": (0.0, 1e-9), "hess_chunk 16, lx": (0.0, 0.0),
              "hess_chunk 16, luu": (0.0, 0.0), "gn vs exact, lx": (0.0, 1e-9),
              "gn vs exact, lu": (0.0, 0.0), "gn vs exact, luu": (0.0, 0.0),
              "trajectory_cost full vs its terms (relative)": (0.0, 1e-12)}
# The JAX package's own float32 backward_pass_assoc on phase 5's long-horizon inputs (made
# by the port on the CPU), max |out - out64| against the float64 serial pass on the same
# inputs (tools/assoc_anchor.py). Phase 10 (c) holds the port's associative pass on the
# card to ASSOC_FACTOR times it: an associative composition rounds worse than the serial
# pass in float32 (the serial pass reads K 1.245e-2, kff 1.024e-3 there), so K4's bar does
# not apply.
ASSOC_ANCHOR = {"K": 0.6526, "kff": 7.513e-4}
ASSOC_FACTOR = 2.0


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


def hands_problem(N=25, dt=0.02, device=None, dtype=None):
    """H1 with hands (nx=103, nu=45) through the library's own entry points:
    load_robot with the ankles as end effectors (its default contact: 8
    points on the ankles), config.yaml's gravity and dt = physics_dt = `dt`;
    build_cost_params with config.yaml's weights; config.yaml's solver as
    shipped (its engine section: structured_frozen_mass, gn, cascade with
    pallas_batched, max_iterations 4, tolerance 1e-3) with backward "pallas"
    at horizon N; as references, the standing state held for N + 1 rows
    (build_reference_set: CoM and ankle tracks by FK, stance 0); and
    build_step_plan's plan. A runner.Problem on `device` (the card when
    None) in `dtype` (float32 when None). tools/port_hands_fixture.py
    builds the same problem in the JAX package."""
    import numpy as np
    import torch
    from mpc_ilqr_tpu_torch.costs.params import build_cost_params
    from mpc_ilqr_tpu_torch.ilqr.solver import ILQRConfig
    from mpc_ilqr_tpu_torch.io.config import load_config
    from mpc_ilqr_tpu_torch.io.references import build_reference_set
    from mpc_ilqr_tpu_torch.models.robot import load_robot, standing_state
    from mpc_ilqr_tpu_torch.mpc import runner
    from mpc_ilqr_tpu_torch.ops.step_plan import build_step_plan

    app = load_config(os.path.join(ROOT, "config.yaml"))
    dtype = dtype or torch.float32
    model = load_robot(os.path.join(ROOT, HANDS_XML), ee_body_names=HANDS_EE,
                       gravity=tuple(app.mpc.gravity), timestep=dt, dtype=dtype,
                       device=torch.device("cuda" if device is None else device))
    cp = build_cost_params(model, app.mpc.cost_weights, app.mpc.constraints, dtype=dtype)
    e = app.engine
    cfg = ILQRConfig(N=N, max_iterations=int(e["max_iterations"]), tolerance=float(e["tolerance"]),
                     cost_mode=e["cost_mode"], line_search=e["line_search"], backward="pallas",
                     linearization=e["linearization"], rollout_backend=e["rollout_backend"],
                     ls_backend=e["ls_backend"], quad_mode=e["quad_mode"])
    q0 = standing_state(model)[:model.nq].cpu().double().numpy()
    refs = build_reference_set(model, np.tile(q0, (N + 1, 1)), np.zeros((N + 1, model.nv)),
                               np.zeros((N + 1, len(HANDS_EE))), dtype=dtype)
    return runner.Problem(model=model, cp=cp, cfg=cfg, refs=refs, app=app,
                          plan=build_step_plan(model))


def hands_inputs(N, dt, device=None):
    """K4's inputs on the hands problem (hands_problem(N, dt)): A, B and the
    GN quadratics along the cold-start rollout (K1 on the card) from
    standing at gravity compensation, as long_horizon_inputs. A dict of
    `prob`, `x0`, `us`, `xs`, `window`, `A`, `B`, `quad` and `args`."""
    from mpc_ilqr_tpu_torch.costs.quadratics import quadraticize_gn
    from mpc_ilqr_tpu_torch.costs.references import extract_window
    from mpc_ilqr_tpu_torch.dynamics import engine
    from mpc_ilqr_tpu_torch.ilqr import solver
    from mpc_ilqr_tpu_torch.models.robot import standing_state

    prob = hands_problem(N, dt, device=device)
    m, cfg = prob.model, prob.cfg
    x0 = standing_state(m)
    us = engine.gravity_comp(m, x0)[None].repeat(N, 1).contiguous()
    xs = solver.rollout(m, cfg, x0, us, plan=prob.plan)
    window = extract_window(prob.refs, 0, N)
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


def riccati_err(label, got, want):
    """max |kernel - plain| where the plain version is finite, after checking
    that K4 is finite exactly where it is and within RICCATI_ATOL +
    RICCATI_RTOL |plain| everywhere else."""
    import torch

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


def riccati_cases(cases, pd_bump):
    """K4 against its plain version on each (N, nx, nu, case, λ) of `cases`
    (riccati_problem's inputs, float32 on the card); the largest
    max|kernel - plain|."""
    import torch
    from mpc_ilqr_tpu_torch.ops import riccati

    k4_err = 0.0
    for N_, nx_, nu_, case, reg_ in cases:
        args = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
                for a in riccati_problem(N_, nx_, nu_, case)]
        got = riccati.backward_pass_kernel(*args, reg_, pd_bump)
        want = riccati.backward_pass_plain(*args, reg_, pd_bump)
        e = riccati_err(f"K4 ({N_}, {nx_}, {nu_}) {case}", got, want)
        if case == "rescued" and not bool(torch.isfinite(got[1][RICCATI_T_BAD]).all()):
            fail("K4: the PD bump did not rescue the zero pivot")
        k4_err = max(k4_err, e)
        print(f"K4 riccati_backward ({N_}, {nx_}, {nu_}) {case}: max|kernel - plain| = {e:.3e} "
              f"(rtol {RICCATI_RTOL}, atol {RICCATI_ATOL}; non-finite at "
              f"{int((~torch.isfinite(got[1])).any(1).sum())} of {N_} steps, as plain)")
    return k4_err


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
    `report` (all four read 0: the batched path takes the plain chains and
    these configs backward "scan"). Returns what phase 11 compares with:
    the seed search (`ss`) and its solution (`sol`), the fleet (`fl`), its
    first chunk's models (`m0`), states (`s0`) and start (`x0s`), that
    chunk's cold step (`warm`) and the chunk's Riccati inputs at the warm
    start (`Ab`, `Bb`, `qb`, λ `reg_t`)."""
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
    s0 = controller.MPCState(**{f: part(getattr(fl.states, f)) for f in fleet_mod.STATE_FIELDS})
    return dict(ss=ss, sol=sol, fl=fl, m0=m0, s0=s0, x0s=x0s, warm=warm, Ab=Ab, Bb=Bb, qb=qb,
                reg_t=reg_t)


def exact_phase(report, smi_line, reset_counts, read_counts):
    """Phase 9: scenarios.exact_standing's closed loop on the card with its
    gates, timings and launches (`report`'s "exact" path), then each other
    new derivative mode once in float64 against its bar."""
    import dataclasses

    import numpy as np
    import torch

    from mpc_ilqr_tpu_torch import scenarios
    from mpc_ilqr_tpu_torch.costs import terms
    from mpc_ilqr_tpu_torch.costs.quadratics import quadraticize, trajectory_cost
    from mpc_ilqr_tpu_torch.costs.references import extract_window
    from mpc_ilqr_tpu_torch.dynamics import engine
    from mpc_ilqr_tpu_torch.ilqr import solver
    from mpc_ilqr_tpu_torch.io.config import load_config
    from mpc_ilqr_tpu_torch.models.robot import load_h1, standing_state
    from mpc_ilqr_tpu_torch.mpc import controller

    # (a) the standing flagship on the reference's own derivative model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ep = scenarios.exact_standing()
    m, cp, cfg, refs, plan = ep.model, ep.cp, ep.cfg, ep.refs, ep.plan
    if plan is None or m.device.type != "cuda":
        fail("exact: setup did not place the problem and its kernel plan on the card")
    print(f"exact: linearization {cfg.linearization!r}, quad_mode {cfg.quad_mode!r}, cost_mode "
          f"{cfg.cost_mode!r}, line search {cfg.line_search!r} ({cfg.rollout_backend}, "
          f"{cfg.ls_backend}), N={cfg.N}, max_iterations {cfg.max_iterations}, {m.dtype}")
    x_init = standing_state(m)
    reset_counts()
    t1 = time.perf_counter()
    _, xT, hist = controller.run_closed_loop(m, cp, cfg, refs, controller.init_state(m, cfg),
                                             x_init, N_STEPS, plan=plan)
    counts = read_counts()
    run_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    costs, xs = hist["cost"].cpu().numpy(), hist["x"].cpu().numpy()
    for i in range(N_STEPS):
        print(f"exact step {i:2d}: cost {costs[i]:.6f}  iterations {hist['iterations'][i]}  "
              f"solve_ok {hist['solve_ok'][i]}  base_z {xs[i, 2]:.6f}")
    base_z = float(xT[2])
    its = sum(hist["iterations"]) / N_STEPS
    print(f"exact ({smi_line}): {run_s * 1e3 / N_STEPS:.2f} ms per MPC step (host clock, one run "
          f"of {N_STEPS} steps), {its:.3f} iterations per step; final cost {costs[-1]:.6f}, final "
          f"base_z {base_z:.6f}; launches {counts}; peak memory {peak / 2**20:.1f} MiB")
    print(f"JAX package's run of the same steps, CPU float32 (information; tools/exact_anchor.py): "
          f"{EXACT_ANCHOR}")
    if not (np.isfinite(xs).all() and bool(torch.isfinite(xT).all())):
        fail("exact: non-finite state in the closed loop")
    if not all(hist["solve_ok"]):
        fail(f"exact: solve_ok false at steps "
             f"{[i for i, ok in enumerate(hist['solve_ok']) if not ok]}")
    if not (1.0 < xs[:, 2].min() and xs[:, 2].max() < 1.1 and 1.0 < base_z < 1.1):
        fail(f"exact: base_z left (1.0, 1.1): min {xs[:, 2].min()}, max {xs[:, 2].max()}, "
             f"final {base_z}")
    if not costs[-1] < costs[0]:
        fail(f"exact: last cost {costs[-1]} is not below the first {costs[0]}")
    for name in ("rollout", "linesearch"):
        if counts[name] < 1:
            fail(f"exact: {name} was not launched")
    for name in report:
        report[name]["launches_by_path"]["exact"] = counts[name]

    # One iteration's derivatives at the last step's window, beside the flagship's modes.
    win = extract_window(refs, N_STEPS - 1, cfg.N)
    ub = hist["u"][-1][None].repeat(cfg.N, 1).contiguous()
    xb = solver.rollout(m, cfg, hist["x"][-1], ub, plan=plan)
    shipped = dataclasses.replace(cfg, linearization="structured_frozen_mass")
    torch.cuda.reset_peak_memory_stats()
    breakdown({
        "linearize (ad)": lambda: solver.linearize(m, cfg, xb, ub),
        "linearize (structured_frozen_mass)": lambda: solver.linearize(m, shipped, xb, ub),
        "quadraticize (exact)": lambda: quadraticize(m, cp, win, xb, ub),
        "quadraticize (gn)": lambda: quadraticize(m, cp, win, xb, ub, hess_mode="gn"),
    }, f"N={cfg.N}")
    print(f"  peak memory of the breakdown: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # (b) every other new mode once, float64, at one nominal
    app = load_config(os.path.join(ROOT, "config.yaml"))
    app.engine.update(dtype="float64", rollout_backend="xla", ls_backend="xla",
                      line_search="first_accept")
    p64 = scenarios.exact_standing(app)
    m64, cp64, N = p64.model, p64.cp, p64.cfg.N
    x0 = standing_state(m64)
    g = torch.Generator().manual_seed(0)
    us = engine.gravity_comp(m64, x0)[None] + 0.1 * torch.randn(
        (N, m64.nu), generator=g, dtype=torch.float64).to(m64.device)
    xb64 = solver.rollout(m64, p64.cfg, x0, us)
    lin = lambda mode, **kw: solver.linearize(m64, dataclasses.replace(
        p64.cfg, linearization=mode, **kw), xb64, us)
    win64 = extract_window(p64.refs, 0, N)
    diff = lambda a, b: float((a - b).abs().max())
    A, B = lin("ad")
    A_fz, B_fz = lin("ad_frozen_mass")
    got = {"ad_frozen_mass vs ad, B": diff(B_fz, B), "ad_frozen_mass vs ad, A": diff(A_fz, A)}
    # "fd" against "ad" in the JAX test's own setting (tests/test_linearize_fd.py:12-24:
    # load_h1's contact, the standing state at gravity compensation, N=3, fd_eps 1e-6).
    # Forward differences carry a truncation error ∝ fd_eps that grows along a horizon
    # as the robot moves (1.2e-2 at the 25th knot of that setting at 1e-6; 4.1e-3 on the
    # nominal below, where impratio 100 stiffens the stiction; the same recipe in the
    # reference): at N=25 the gap must shrink tenfold with fd_eps.
    hm = load_h1(gravity=(0.0, 0.0, -1.0), timestep=0.02, dtype=torch.float64)
    hx0 = standing_state(hm)
    hus = engine.gravity_comp(hm, hx0)[None].repeat(3, 1)
    hcfg = dataclasses.replace(p64.cfg, linearization="ad", N=3)
    hxs = solver.rollout(hm, hcfg, hx0, hus)
    hA, hB = solver.linearize(hm, hcfg, hxs, hus)
    hA_fd, hB_fd = solver.linearize(hm, dataclasses.replace(hcfg, linearization="fd",
                                                            fd_eps=1e-6), hxs, hus)
    got["fd vs ad"] = max(diff(hA_fd, hA), diff(hB_fd, hB))
    gaps = {}
    for eps in (1e-5, 1e-6, 1e-7):
        A_fd, B_fd = lin("fd", fd_eps=eps)
        gaps[eps] = max(diff(A_fd, A), diff(B_fd, B))
    got["fd truncation, gap(1e-6) / gap(1e-7)"] = gaps[1e-6] / gaps[1e-7]
    print(f"  fd vs ad on the main path's model, by fd_eps: "
          + ", ".join(f"{e:g}: {g:.3e}" for e, g in gaps.items()))
    for mode in ("ad", "structured", "structured_frozen_mass"):
        full = (A, B) if mode == "ad" else lin(mode)
        chunked = lin(mode, lin_chunk=16)
        got[f"lin_chunk 16 ({mode})"] = max(diff(chunked[0], full[0]), diff(chunked[1], full[1]))
    q0 = quadraticize(m64, cp64, win64, xb64, us)
    qc = quadraticize(m64, cp64, win64, xb64, us, hess_chunk=16)
    qg = quadraticize(m64, cp64, win64, xb64, us, hess_mode="gn")
    for f in ("lxx", "lx", "luu"):
        got[f"hess_chunk 16, {f}"] = diff(getattr(qc, f), getattr(q0, f))
    for f in ("lx", "lu", "luu"):
        got[f"gn vs exact, {f}"] = diff(getattr(qg, f), getattr(q0, f))
    full_cost = float(trajectory_cost(m64, cp64, win64, xb64, us, mode="full"))
    by_term = {}
    for t in range(N + 1):
        x = xb64[t]
        w = (win64.x[t], win64.com[t], win64.com_vel[t], win64.ee_pos[t], win64.stance[t])
        parts = dict(tracking=terms.tracking_cost(cp64, x, w[0], *(
            (us[t], win64.u[t]) if t < N else ()), terminal=t == N, model=m64),
            com=terms.com_cost(m64, cp64, x, w[1]),
            ee_pos=terms.ee_pos_cost(m64, cp64, x, w[3], w[4]),
            ee_vel=terms.ee_vel_cost(m64, cp64, x, w[4]), upright=terms.upright_cost(cp64, x),
            balance=terms.balance_cost(m64, cp64, x, w[3], w[4]),
            joint_limit=terms.joint_limit_cost(m64, cp64, x))
        if t < N:
            parts.update(com_vel=terms.com_vel_cost(m64, cp64, x, w[2]),
                         torque_limit=terms.torque_limit_cost(m64, cp64, us[t]))
        for k, v in parts.items():
            by_term[k] = by_term.get(k, 0.0) + float(v)
    got["trajectory_cost full vs its terms (relative)"] = (
        abs(full_cost - sum(by_term.values())) / max(1.0, abs(full_cost)))
    print(f"exact (b), float64 on the card, H1, N={N}: full cost {full_cost:.9f} = "
          + ", ".join(f"{k} {v:.6g}" for k, v in by_term.items()))
    for k, v in got.items():
        lo, hi = EXACT_BARS[k]
        print(f"  {k}: {v:.3e} (bar {f'{lo} to {hi}' if lo else hi})")
    bad = [k for k, v in got.items() if not EXACT_BARS[k][0] <= v <= EXACT_BARS[k][1]]
    if bad:
        fail(f"exact (b): {bad} beyond their bars ({[got[k] for k in bad]})")

    # One float32 solve with cost_mode "full", K1-K3 through the plan.
    fcfg = dataclasses.replace(cfg, cost_mode="full")
    x0f = standing_state(m)
    u0 = engine.gravity_comp(m, x0f)[None].repeat(cfg.N, 1)
    wf = extract_window(refs, 0, cfg.N)
    c0 = float(trajectory_cost(m, cp, wf, solver.rollout(m, fcfg, x0f, u0, plan=plan), u0,
                               mode="full"))
    t1 = time.perf_counter()
    sol = solver.solve(m, cp, fcfg, x0f, wf, u0, plan=plan)
    torch.cuda.synchronize()
    print(f"exact, cost_mode 'full' (float32): success {sol.success}, iterations {sol.iterations},"
          f" cost {c0:.6f} -> {float(sol.cost):.6f} in {(time.perf_counter() - t1) * 1e3:.1f} ms")
    if not (sol.success and bool(torch.isfinite(sol.cost)) and float(sol.cost) < c0):
        fail(f"exact: the cost_mode 'full' solve failed (success {sol.success}, cost "
             f"{float(sol.cost)} from {c0})")


def shards_phase(report, smi_line, reset_counts, read_counts, ctx):
    """Phase 10: the sharded line search and fleet step on a world-1 NCCL
    group, long horizon (a) with the associative Riccati pass, and the
    quaternion FK; launches recorded in `report` ("sharded_standing",
    "sharded_fleet", "long_horizon_assoc"). `ctx` carries earlier phases'
    problem and readings: the standing problem (`standing`), phase 5's
    long-horizon inputs (`lh_args`, `A`, `B`, `quad`, `reg`, `pd`), their
    float64 serial gains (`p64`) and K4's distance from them (`k4_err`),
    and phase 6's ms per control step (`lh_ms`)."""
    import dataclasses
    import datetime
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from mpc_ilqr_tpu_torch import scenarios
    from mpc_ilqr_tpu_torch.costs.quadratics import CostQuadratics
    from mpc_ilqr_tpu_torch.dynamics import engine
    from mpc_ilqr_tpu_torch.dynamics import math as qm
    from mpc_ilqr_tpu_torch.dynamics.kinematics import forward_kinematics
    from mpc_ilqr_tpu_torch.ilqr import solver
    from mpc_ilqr_tpu_torch.models.robot import ARRAY_FIELDS, load_h1, load_robot, standing_state
    from mpc_ilqr_tpu_torch.mpc import controller
    from mpc_ilqr_tpu_torch.ops import riccati
    from mpc_ilqr_tpu_torch.ops.assoc_riccati import backward_pass_assoc
    from mpc_ilqr_tpu_torch.ops.quat_fk import build_level_plans, quat_frames
    from mpc_ilqr_tpu_torch.parallel import fleet as fleet_mod
    from mpc_ilqr_tpu_torch.parallel.sharded_solve import step_once_sharded
    from mpc_ilqr_tpu_torch.parallel.sharding import make_mesh, place_fleet, shard_fleet_step

    def record(label, counts):
        for name in report:
            report[name]["launches_by_path"][label] = counts[name]

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=300),
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    mesh = make_mesh(1)
    print(f"shards: NCCL world of {dist.get_world_size()}, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    if tuple(mesh.shape) != (1, 1):
        fail(f"shards: make_mesh(1) gave {tuple(mesh.shape)}, not dp = ls = 1")

    # (a) The standing flagship through step_once_sharded, against the local step_once.
    model, cp, cfg, refs, plan = ctx["standing"]
    scfg = dataclasses.replace(cfg, line_search="first_accept", ls_backend="pallas_batched")

    def loop(step):
        """run_closed_loop's steps with `step` as the controller."""
        state, x, rec = controller.init_state(model, scfg), standing_state(model), []
        for _ in range(N_STEPS):
            state, u, diag = step(state, x)
            rec.append((x, u, diag))
            x = engine.step(model, x, u)
        return rec, x

    reset_counts()
    t1 = time.perf_counter()
    rec_s, xT_s = loop(lambda st, x: step_once_sharded(mesh, model, cp, scfg, refs, st, x,
                                                       plan=plan))
    counts = read_counts()
    ms_s = (time.perf_counter() - t1) * 1e3 / N_STEPS
    t1 = time.perf_counter()
    rec_l, xT_l = loop(lambda st, x: controller.step_once(model, cp, scfg, refs, st, x, plan=plan))
    torch.cuda.synchronize()
    ms_l = (time.perf_counter() - t1) * 1e3 / N_STEPS
    costs = np.array([float(d.cost) for _, _, d in rec_s])
    zs = np.array([float(x[2]) for x, _, _ in rec_s] + [float(xT_s[2])])
    for i, ((x, u, d), (xl, ul, dl)) in enumerate(zip(rec_s, rec_l)):
        same = (d.iterations == dl.iterations and d.solve_ok == dl.solve_ok
                and torch.equal(d.cost, dl.cost) and torch.equal(u, ul) and torch.equal(x, xl))
        print(f"sharded step {i:2d}: cost {float(d.cost):.6f}  iterations {d.iterations}  solve_ok "
              f"{d.solve_ok}  base_z {float(x[2]):.6f}  equal to local {same}")
        if not same:
            fail(f"shards: step_once_sharded parts from the local step_once at step {i} "
                 f"(cost {float(d.cost)} vs {float(dl.cost)}, iterations {d.iterations} vs "
                 f"{dl.iterations}, max|du| {float((u - ul).abs().max()):.3e})")
    if not torch.equal(xT_s, xT_l):
        fail("shards: the sharded and the local closed loop end in different states")
    print(f"sharded standing ({smi_line}): {ms_s:.2f} ms per MPC step (host clock, one run of "
          f"{N_STEPS} steps; the local step_once with the same config {ms_l:.2f}); first_accept, "
          f"ls_backend pallas_batched; final cost {costs[-1]:.6f}, final base_z {zs[-1]:.6f}; "
          f"launches {counts}")
    if not (bool(torch.isfinite(torch.stack([x for x, _, _ in rec_s])).all())
            and bool(torch.isfinite(xT_s).all())):
        fail("shards: non-finite state in the sharded closed loop")
    if not all(d.solve_ok for _, _, d in rec_s):
        fail(f"shards: solve_ok false at steps {[i for i, r in enumerate(rec_s) if not r[2].solve_ok]}")
    if not (1.0 < zs.min() and zs.max() < 1.1):
        fail(f"shards: base_z left (1.0, 1.1): min {zs.min()}, max {zs.max()}")
    if not costs[-1] < costs[0]:
        fail(f"shards: last cost {costs[-1]} is not below the first {costs[0]}")
    for name in ("rollout", "linesearch_batched"):
        if counts[name] < 1:
            fail(f"shards: {name} was not launched by the sharded closed loop")
    record("sharded_standing", counts)

    # (b) One chunk of the fleet through shard_fleet_step, against fleet_step_once.
    fl = scenarios.fleet()
    fp, chunk = fl.prob, fl.chunk
    part = lambda t: t[:chunk]
    m0 = fl.models.replace(**{f: part(getattr(fl.models, f)) for f in ARRAY_FIELDS})
    s0 = controller.MPCState(**{f: part(getattr(fl.states, f)) for f in fleet_mod.STATE_FIELDS})
    x0s = part(fl.xs)
    reset_counts()
    t1 = time.perf_counter()
    step = shard_fleet_step(mesh, place_fleet(mesh, m0), fp.cp, fp.cfg, fp.refs)
    st_s, u_s, d_s, mean_s, ok_s = step(place_fleet(mesh, s0), place_fleet(mesh, x0s))
    counts = read_counts()
    chunk_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    st_l, u_l, d_l = fleet_mod.fleet_step_once(m0, fp.cp, fp.cfg, fp.refs, s0, x0s)
    torch.cuda.synchronize()
    chunk_l = time.perf_counter() - t1
    want_mean = d_l.cost.double().sum() / chunk
    print(f"sharded fleet ({smi_line}): one chunk of {chunk}: {chunk_s * 1e3:.1f} ms by "
          f"shard_fleet_step, {chunk_l * 1e3:.1f} ms by fleet_step_once (host clock); mean cost "
          f"{float(mean_s):.9f} (fleet_step_once {float(want_mean):.9f}), solve_ok {int(ok_s)} "
          f"(fleet_step_once {int(d_l.solve_ok.sum())}) of {chunk}; controls equal "
          f"{torch.equal(u_s, u_l)}; launches {counts}")
    if not bool(torch.isfinite(u_s).all()):
        fail("shards: non-finite controls from shard_fleet_step")
    if not (torch.equal(u_s, u_l) and torch.equal(mean_s, want_mean)
            and int(ok_s) == int(d_l.solve_ok.sum())):
        fail(f"shards: shard_fleet_step parts from fleet_step_once (max|du| "
             f"{float((u_s - u_l).abs().max()):.3e}, mean {float(mean_s)} vs {float(want_mean)}, "
             f"solve_ok {int(ok_s)} vs {int(d_l.solve_ok.sum())})")
    if any(counts.values()):
        fail(f"shards: the fleet launched a kernel ({counts}); it takes the plain chains")
    record("sharded_fleet", counts)

    # (c) Long horizon (a) with the associative Riccati pass.
    prob_, n_steps = scenarios.long_horizon(tuned=True, backward="assoc")
    drive = lambda: controller.run_closed_loop(
        prob_.model, prob_.cp, prob_.cfg, prob_.refs, controller.init_state(prob_.model, prob_.cfg),
        standing_state(prob_.model), n_steps, plan=prob_.plan)
    reset_counts()
    t1 = time.perf_counter()
    _, xT_, h = drive()
    counts = read_counts()
    first_s = time.perf_counter() - t1
    xs_, costs_ = h["x"].cpu().numpy(), h["cost"].cpu().numpy()
    for i in range(len(costs_)):
        print(f"long_horizon_assoc solve {i}: cost {costs_[i]:.6f}  iterations {h['iterations'][i]}"
              f"  solve_ok {h['solve_ok'][i]}  base_z {xs_[i, 2]:.6f}")
    z_ = float(xT_[2])
    print(f"long_horizon_assoc: {n_steps} control steps, N={prob_.cfg.N}, backward "
          f"{prob_.cfg.backward!r}, final base_z {z_:.6f}, final cost {costs_[-1]:.6f}; launches "
          f"{counts}; first run {first_s:.2f} s")
    if not (np.isfinite(xs_).all() and bool(torch.isfinite(xT_).all())):
        fail("long_horizon_assoc: non-finite state")
    if not all(h["solve_ok"]):
        fail(f"long_horizon_assoc: solve_ok false at solves "
             f"{[i for i, ok in enumerate(h['solve_ok']) if not ok]}")
    if not (1.0 < xs_[:, 2].min() and xs_[:, 2].max() < 1.1 and 1.0 < z_ < 1.1):
        fail(f"long_horizon_assoc: base_z left (1.0, 1.1): min {xs_[:, 2].min()}, max "
             f"{xs_[:, 2].max()}, final {z_}")
    for name in ("rollout", "linesearch"):
        if counts[name] < 1:
            fail(f"long_horizon_assoc: {name} was not launched")
    if counts["riccati"]:
        fail(f"long_horizon_assoc: K4 launched {counts['riccati']} times; assoc takes its place")
    record("long_horizon_assoc", counts)
    t1 = time.perf_counter()
    drive()
    torch.cuda.synchronize()
    print(f"long_horizon_assoc ({smi_line}): {(time.perf_counter() - t1) * 1e3 / n_steps:.2f} ms "
          f"per control step (host clock, warm, {n_steps} steps); phase 6's long_horizon_tuned "
          f"(backward 'pallas', K4) {ctx['lh_ms']['long_horizon_tuned']:.2f}")
    A_, B_, lq, reg_t, pd = (ctx[k] for k in ("A", "B", "quad", "reg", "pd"))
    breakdown({
        "backward_pass_assoc": lambda: backward_pass_assoc(A_, B_, lq, reg_t, pd),
        "K4 riccati_backward": lambda: riccati.backward_pass_kernel(*ctx["lh_args"], reg_t, pd),
        "backward_pass (port loop)": lambda: solver.backward_pass(A_, B_, lq, reg_t, pd),
    }, f"N={prob_.cfg.N}, one backward pass")

    # K and kff against the float64 serial pass: float64 on tests/test_ops.py:64-86's
    # problem, then float32 on phase 5's long-horizon inputs.
    rng = np.random.default_rng(1)
    N, nx, nu = 100, 12, 5
    t64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device="cuda")
    A64 = t64(np.eye(nx) + 0.01 * rng.normal(size=(N, nx, nx)))
    B64 = t64(0.02 * rng.normal(size=(N, nx, nu)))
    q64 = CostQuadratics(
        lx=t64(rng.normal(size=(N + 1, nx))), lu=t64(rng.normal(size=(N, nu))),
        lxx=t64(np.einsum("ti,ij->tij", rng.uniform(0.5, 3, (N + 1, nx)), np.eye(nx))),
        luu=t64(np.einsum("ti,ij->tij", rng.uniform(0.05, 1, (N, nu)), np.eye(nu))))
    reg64 = t64(1e-6)
    got = backward_pass_assoc(A64, B64, q64, reg64, 1e-4)
    want = solver.backward_pass(A64, B64, q64, reg64, 1e-4)
    for out, g, w in zip(("K", "kff"), got, want):
        e = float((g - w).abs().max())
        ok = bool(((g - w).abs() <= 1e-9 + 1e-8 * w.abs()).all())
        print(f"backward_pass_assoc, float64, (N, nx, nu) = ({N}, {nx}, {nu}): {out} "
              f"max|assoc - serial| {e:.3e} (rtol 1e-8, atol 1e-9: {ok})")
        if not ok:
            fail(f"backward_pass_assoc: float64 {out} beyond rtol 1e-8 / atol 1e-9 ({e:.3e})")
    p64 = ctx["p64"]
    got = backward_pass_assoc(A_, B_, lq, reg_t, pd)
    for j, out in enumerate(("K", "kff")):
        e = float((got[j].double() - p64[j]).abs().max())
        bar = ASSOC_FACTOR * ASSOC_ANCHOR[out]
        print(f"backward_pass_assoc on the long-horizon inputs (N={A_.shape[0]}, float32), {out}: "
              f"|assoc - plain64| {e:.3e} (K4 {ctx['k4_err'][out]:.3e}; the JAX package's "
              f"float32 assoc {ASSOC_ANCHOR[out]:.4g}; bar {bar:.4g})")
        if not e <= bar:
            fail(f"backward_pass_assoc: float32 {out} further from float64 than {ASSOC_FACTOR}x "
                 f"the reference's own associative pass ({e:.3e} > {bar:.3e})")

    # (d) The quaternion FK against the matrix FK, float64.
    rng = np.random.default_rng(11)
    hand = os.path.join(ROOT, "robots", "h1_description", "mjcf", "h1_with_hand.xml")
    for label, m in (("h1", load_h1(dtype=torch.float64)),
                     ("h1_with_hand", load_robot(hand, dtype=torch.float64))):
        plans = build_level_plans(m)
        e_p = e_r = 0.0
        for _ in range(3):
            q = np.zeros(m.nq)
            q[:3] = rng.normal(size=3)
            quat = rng.normal(size=4)
            q[3:7] = quat / np.linalg.norm(quat)
            q[7:] = rng.normal(0, 0.5, m.nq - 7)
            qt = torch.as_tensor(q, dtype=torch.float64, device=m.device)
            Q, P = quat_frames(m, plans, qt)
            fr = forward_kinematics(m, qt)
            for got, want in ((P, fr.p), (qm.quat_to_mat(Q), fr.R)):
                if not bool(((got - want).abs() <= 1e-12 + 1e-7 * want.abs()).all()):
                    fail(f"quat_frames on {label}: beyond atol 1e-12 / rtol 1e-7 of "
                         f"forward_kinematics ({float((got - want).abs().max()):.3e})")
            e_p = max(e_p, float((P - fr.p).abs().max()))
            e_r = max(e_r, float((qm.quat_to_mat(Q) - fr.R).abs().max()))
        print(f"quat_frames on {label} ({m.nbody} bodies, {Q.device}, float64): max|P - p| "
              f"{e_p:.3e}, max|R(Q) - R| {e_r:.3e} (atol 1e-12, rtol 1e-7)")
    dist.destroy_process_group()


def k4_phase(report, smi_line, reset_counts, read_counts, ctx):
    """Phase 11: K4 at every input the TPU kernel takes. (a) the random
    cases past the narrow design's sizes; (b) the hands problem's own inputs
    at N=25 and N=100 against float64; (c) the hands solve at both sizes
    against backward "scan"; (d) the batch: a fleet chunk and the seed
    search with backward "pallas" against phase 8's "scan" runs (`ctx`:
    batched_phase's return), the chunk under sync-debug "error"; (e) K4's
    times at the hands sizes and at B=128 (the chunk's own inputs) beside
    the plain version and the port's loops. Launches into `report`."""
    import dataclasses

    import torch
    from torch.func import vmap

    from mpc_ilqr_tpu_torch.costs.quadratics import (CostQuadratics, quadraticize_gn,
                                                     trajectory_costs)
    from mpc_ilqr_tpu_torch.costs.references import extract_window
    from mpc_ilqr_tpu_torch.dynamics import engine
    from mpc_ilqr_tpu_torch.ilqr import solver
    from mpc_ilqr_tpu_torch.models.robot import standing_state
    from mpc_ilqr_tpu_torch.ops import _build
    from mpc_ilqr_tpu_torch.ops import riccati
    from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk
    from mpc_ilqr_tpu_torch.parallel import fleet as fleet_mod

    k4 = report["riccati"]
    lib = _build.library()
    for nx_, nu_ in ((103, 45), (128, 64), (riccati.MAX_NX, riccati.MAX_NU)):
        n_cta = lib.mpc_riccati_cluster(nx_, nu_)
        resident = lib.mpc_riccati_active_clusters(nx_, nu_)
        print(f"K4 at (nx, nu) = ({nx_}, {nu_}): riccati_backward_wide, a cluster of {n_cta} "
              f"CTAs per instance, shared memory per CTA {lib.mpc_riccati_smem_bytes(nx_, nu_)} "
              f"bytes, global scratch per instance {4 * lib.mpc_riccati_scratch_floats(nx_, nu_)} "
              f"bytes; {resident} such clusters resident at once")
        if n_cta < 1 or resident < 1 or lib.mpc_riccati_scratch_floats(nx_, nu_) != 0:
            fail(f"K4's wide design cannot launch at ({nx_}, {nu_})")

    # (a) the random cases at the sizes past the narrow design's
    pd = solver.ILQRConfig().pd_bump
    k4["max_abs_err"] = max(k4["max_abs_err"], riccati_cases(
        [c for c in RICCATI_CASES if c[1] > 64 or c[2] > 32], pd))

    # (b) the hands problem's own inputs, against float64; (e) their times
    for N, dt in HANDS_SIZES:
        li = hands_inputs(N, dt)
        args, hcfg = li["args"], li["prob"].cfg
        nx, nu = li["prob"].model.nx, li["prob"].model.nu
        reg_t = torch.tensor(hcfg.reg_init, device="cuda")
        run = lambda: riccati.backward_pass_kernel(*args, reg_t, pd)
        got = run()
        if riccati.LAST_LAUNCH["nx"] != nx or riccati.LAST_LAUNCH["nu"] != nu:
            fail(f"K4 hands: the last launch was {riccati.LAST_LAUNCH}")
        p32 = riccati.backward_pass_plain(*args, reg_t, pd)
        *p64, bumped = riccati.backward_pass_plain(*[t.double() for t in args], hcfg.reg_init, pd,
                                                   with_bumps=True)
        for j, out in enumerate(("K", "kff")):
            if not bool(torch.isfinite(got[j]).all()):
                fail(f"K4 hands (N={N}): non-finite {out}")
            e_k = float((got[j].double() - p64[j]).abs().max())
            e_p = float((p32[j].double() - p64[j]).abs().max())
            bar = RICCATI_ATOL + 2.0 * e_p
            print(f"K4 on the hands inputs (N={N}, nx={nx}, nu={nu}), {out}: |kernel-plain64| "
                  f"{e_k:.3e}, |plain32-plain64| {e_p:.3e} (bar {bar:.3e}); max |{out}| "
                  f"{float(p64[j].abs().max()):.3e}")
            if not e_k <= bar:
                fail(f"K4 hands (N={N}) {out} further from float64 than float32 allows "
                     f"({e_k:.3e} > {bar:.3e})")
            k4[f"hands_n{N}_{out}_err_vs_f64"] = e_k
            k4[f"hands_n{N}_{out}_plain32_err_vs_f64"] = e_p
        quad_t = CostQuadratics(*args[2:])
        ms = event_ms(run, 5)
        plain_ms = event_ms(lambda: riccati.backward_pass_plain(*args, reg_t, pd), 1)
        loop_ms = event_ms(lambda: solver.backward_pass(args[0], args[1], quad_t, reg_t, pd), 2)
        n_bytes, flops = riccati_bytes(N, nx, nu), riccati_flops(N, nx, nu, int(bumped.sum()))
        bound_ms, bound_by = bound(n_bytes, flops)
        print(f"  N={N} ({smi_line}): K4 {ms:.4f} ms/launch (plain {plain_ms:.3f} ms; port loop "
              f"solver.backward_pass {loop_ms:.3f} ms; bound {bound_ms:.6e} ms by {bound_by}: "
              f"{n_bytes} bytes, {flops} flop; PD bumps at {bumped.nonzero().flatten().tolist()})")
        k4.update({f"ms_hands_n{N}": ms, f"plain_ms_hands_n{N}": plain_ms,
                   f"port_loop_ms_hands_n{N}": loop_ms, f"bound_ms_hands_n{N}": bound_ms})

    # (c) the hands solve at both sizes, "pallas" (K4) against "scan"
    for N, dt in HANDS_SIZES:
        prob = hands_problem(N, dt)
        m, hcfg = prob.model, prob.cfg
        x0 = standing_state(m)
        u0 = engine.gravity_comp(m, x0)[None].repeat(N, 1).contiguous()
        win = extract_window(prob.refs, 0, N)
        go = lambda c: solver.solve(m, prob.cp, c, x0, win, u0, plan=prob.plan)
        reset_counts()
        t1 = time.perf_counter()
        sol = go(hcfg)
        counts = read_counts()
        first_s = time.perf_counter() - t1
        scan = go(dataclasses.replace(hcfg, backward="scan"))
        torch.cuda.synchronize()
        d_cost = abs(float(sol.cost) - float(scan.cost)) / max(1.0, abs(float(scan.cost)))
        label = f"hands_n{N}"
        print(f"{label}: N={N}, dt {dt}, {hcfg.line_search} ({hcfg.rollout_backend}, "
              f"{hcfg.ls_backend}), backward {hcfg.backward!r}: iterations {sol.iterations}, "
              f"solve_ok {sol.success}, attempts {sol.attempts}, cost {float(sol.cost):.6f}; "
              f"backward 'scan': iterations {scan.iterations}, solve_ok {scan.success}, cost "
              f"{float(scan.cost):.6f} (relative gap {d_cost:.3e}, bar {SEED_COST_RTOL}); "
              f"launches {counts}; first run {first_s:.2f} s")
        outs = (sol.xbar, sol.ubar, sol.K, sol.kff, sol.cost)
        if not all(bool(torch.isfinite(t).all()) for t in outs):
            fail(f"{label}: non-finite states, controls, gains or cost")
        if (sol.iterations, sol.success) != (scan.iterations, scan.success):
            fail(f"{label}: iterations / solve_ok {sol.iterations} / {sol.success} against "
                 f"'scan' {scan.iterations} / {scan.success}")
        if not d_cost <= SEED_COST_RTOL:
            fail(f"{label}: final cost {float(sol.cost)} parts from 'scan' {float(scan.cost)}")
        if counts["riccati"] != sol.attempts:
            fail(f"{label}: K4 launched {counts['riccati']} times for {sol.attempts} backward "
                 f"passes")
        for name in ("rollout", "linesearch"):
            if counts[name] < 1:
                fail(f"{label}: {name} was not launched")
        for name in report:
            report[name]["launches_by_path"][label] = counts[name]
        k4["launches"] += counts["riccati"]
        secs, _ = host_seconds(lambda: go(hcfg), 1)
        print(f"{label} ({smi_line}): {secs * 1e3 / sol.iterations:.2f} ms per iteration (host "
              f"clock, one warm solve of {sol.iterations} iterations: {secs * 1e3:.1f} ms)")
        k4[f"hands_n{N}_ms_per_iteration"] = secs * 1e3 / sol.iterations
    # Where a hands iteration's time goes at N=100, on (b)'s inputs.
    xb, ub = li["xs"], li["us"]
    Kf, kf = riccati.backward_pass_kernel(*args, reg_t, pd)
    al = torch.tensor(hcfg.alphas, device="cuda")
    hp = li["prob"]
    breakdown({
        "linearize (step_and_jac, vmapped)": lambda: solver.linearize(hp.model, hcfg, xb, ub),
        "quadraticize_gn": lambda: quadraticize_gn(hp.model, hp.cp, li["window"], xb, ub),
        "K4 riccati_backward_wide": lambda: riccati.backward_pass_kernel(*args, reg_t, pd),
        "backward_pass (port loop)": lambda: solver.backward_pass(args[0], args[1], quad_t,
                                                                  reg_t, pd),
        "trajectory_costs (1 candidate)": lambda: trajectory_costs(
            hp.model, hp.cp, li["window"], xb[None], ub[None]),
        "K1 rollout_kernel": lambda: rk.rollout_kernel(hp.model, hp.plan, li["x0"], ub),
        "K2 linesearch (A=1)": lambda: rk.linesearch_rollout_kernel(
            hp.model, hp.plan, li["x0"], xb, ub, Kf, kf, al[:1]),
        "K3 linesearch_batched (A=7)": lambda: rk.linesearch_rollout_kernel_batched(
            hp.model, hp.plan, li["x0"], xb, ub, Kf, kf, al[1:]),
    }, f"hands, N={xb.shape[0] - 1}", reps=1)

    # (d) the batch: one fleet chunk and the seed search with backward "pallas"
    fl, ss = ctx["fl"], ctx["ss"]
    fp, chunk = fl.prob, fl.chunk
    fcfg = dataclasses.replace(fp.cfg, backward="pallas")
    cfgb = solver.batched_config(fcfg)
    attempts_run = cfgb.max_iterations * (1 if cfgb.inner_attempts == 1 else 2)
    reset_counts()
    t1 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, u, d = fleet_mod.fleet_step_once(ctx["m0"], fp.cp, fcfg, fp.refs, ctx["s0"], ctx["x0s"])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = read_counts()
    chunk_s = time.perf_counter() - t1
    last = dict(riccati.LAST_LAUNCH)
    _, u_s, d_s = ctx["warm"]
    gap_u = float((u - u_s).abs().max())
    mean_p, mean_s = float(d.cost.double().mean()), float(d_s.cost.double().mean())
    gap_c = abs(mean_p - mean_s) / max(1.0, abs(mean_s))
    print(f"fleet chunk, backward 'pallas' ({smi_line}): {chunk} instances under sync debug mode "
          f"'error' (no host sync), {chunk_s * 1e3:.1f} ms (host clock; phase 8's 'scan' chunk "
          f"beside it in its lines); solve_ok {int(d.solve_ok.sum())} ('scan' "
          f"{int(d_s.solve_ok.sum())}) of {chunk}, mean cost {mean_p:.6f} ('scan' {mean_s:.6f}, "
          f"relative gap {gap_c:.3e}, bar {SEED_COST_RTOL}), max|u - u_scan| {gap_u:.3e} (bar "
          f"{SEED_UBAR_ATOL}); K4 launches {counts['riccati']} ({attempts_run} attempts run), "
          f"the last with batch {last['batch']}; launches {counts}")
    if not bool(torch.isfinite(u).all()):
        fail("fleet 'pallas': non-finite controls")
    if not (int(d.solve_ok.sum()) == int(d_s.solve_ok.sum()) and gap_u <= SEED_UBAR_ATOL
            and gap_c <= SEED_COST_RTOL):
        fail("fleet 'pallas': the chunk parts from the same chunk with 'scan'")
    if counts["riccati"] != attempts_run or last["batch"] != chunk:
        fail(f"fleet 'pallas': K4 launched {counts['riccati']} times (want {attempts_run}), "
             f"the last with batch {last['batch']} (want {chunk})")
    for name in report:
        report[name]["launches_by_path"]["fleet_pallas"] = counts[name]
    k4["launches"] += counts["riccati"]

    sp = ss.prob
    scfg = dataclasses.replace(sp.cfg, backward="pallas")
    reset_counts()
    t1 = time.perf_counter()
    sol = solver.solve_batched(sp.model, sp.cp, scfg, ss.x0, ss.window, ss.seeds)
    counts = read_counts()
    secs = time.perf_counter() - t1
    want = ctx["sol"]
    n_seeds = ss.seeds.shape[0]
    gap_c = float(((sol.cost.double() - want.cost.double()).abs()
                   / want.cost.double().abs().clamp(min=1.0)).max())
    gap_u = float((sol.ubar - want.ubar).abs().max())
    sb = solver.batched_config(scfg)
    runs = sb.max_iterations * (1 if sb.inner_attempts == 1 else 2)
    print(f"batched_linesearch, backward 'pallas' ({smi_line}): {secs * 1e3:.2f} ms per batched "
          f"solve (host clock, one call); success {int(sol.success.sum())} ('scan' "
          f"{int(want.success.sum())}) of {n_seeds}, relative cost gap {gap_c:.3e} (bar "
          f"{SEED_COST_RTOL}), max|ubar gap| {gap_u:.3e} (bar {SEED_UBAR_ATOL}); K4 launches "
          f"{counts['riccati']} ({runs} attempts run), the last with batch "
          f"{riccati.LAST_LAUNCH['batch']}")
    if not bool(torch.isfinite(sol.cost).all()):
        fail("batched_linesearch 'pallas': non-finite cost")
    if not (int(sol.success.sum()) == int(want.success.sum()) and gap_c <= SEED_COST_RTOL
            and gap_u <= SEED_UBAR_ATOL):
        fail("batched_linesearch 'pallas': the seeds part from the same search with 'scan'")
    if counts["riccati"] != runs or riccati.LAST_LAUNCH["batch"] != n_seeds:
        fail(f"batched_linesearch 'pallas': K4 launched {counts['riccati']} times (want {runs}), "
             f"the last with batch {riccati.LAST_LAUNCH['batch']} (want {n_seeds})")
    for name in report:
        report[name]["launches_by_path"]["batched_linesearch_pallas"] = counts[name]
    k4["launches"] += counts["riccati"]

    # (e) B=128 at H1's sizes: the fleet chunk's own inputs at the warm start. Each
    # instance's gains are its own single launch's to the bit; on config.yaml's contact
    # two float32 passes part by more than 2e-4, so the batch is held to float64 no
    # further than float32 allows, as phase 5 holds the long-horizon inputs.
    Ab, Bb, qb, reg_b = ctx["Ab"], ctx["Bb"], ctx["qb"], ctx["reg_t"]
    n, N, nx, nu = Ab.shape[0], Ab.shape[1], Ab.shape[-1], Bb.shape[-1]
    ins = tuple(t.contiguous() for t in (Ab, Bb, *qb))
    batch_k4 = lambda: vmap(lambda *a: riccati.backward_pass_kernel(*a, reg_b, pd))(*ins)
    got = batch_k4()
    for i in range(4):
        one = riccati.backward_pass_kernel(*(t[i] for t in ins), reg_b, pd)
        if not all(torch.equal(g[i], o) for g, o in zip(got, one)):
            fail(f"K4 batch of {n}: instance {i} differs from its own single launch")
    p32 = vmap(lambda *a: riccati.backward_pass_plain(*a, reg_b, pd))(*ins)
    *p64, bumped = vmap(lambda *a: riccati.backward_pass_plain(*a, reg_b.double(), pd,
                                                               with_bumps=True))(
        *(t.double() for t in ins))
    for j, out in enumerate(("K", "kff")):
        if not bool(torch.isfinite(got[j]).all()):
            fail(f"K4 batch of {n}: non-finite {out}")
        e_k = float((got[j].double() - p64[j]).abs().max())
        e_p = float((p32[j].double() - p64[j]).abs().max())
        bar = RICCATI_ATOL + 2.0 * e_p
        print(f"K4 batch of {n}, {out}: |kernel-plain64| {e_k:.3e}, |plain32-plain64| {e_p:.3e} "
              f"(bar {bar:.3e}); max|kernel - plain32| "
              f"{float((got[j] - p32[j]).abs().max()):.3e}; max |{out}| "
              f"{float(p64[j].abs().max()):.3e}; instances 0-3 equal to their single launches")
        if not e_k <= bar:
            fail(f"K4 batch of {n}: {out} further from float64 than float32 allows ({e_k:.3e} > "
                 f"{bar:.3e})")
        k4[f"batch128_n25_{out}_err_vs_f64"] = e_k
        k4[f"batch128_n25_{out}_plain32_err_vs_f64"] = e_p
    ms = event_ms(batch_k4, 10)
    plain_ms = event_ms(lambda: vmap(lambda *a: riccati.backward_pass_plain(*a, reg_b, pd))(*ins),
                        1)
    loop_ms = event_ms(lambda: vmap(lambda A, B, q: solver.backward_pass(A, B, q, reg_b, pd))(
        Ab, Bb, qb), 1)
    n_bytes = n * riccati_bytes(N, nx, nu)
    flops = n * riccati_flops(N, nx, nu, 0) + int(bumped.sum()) * (riccati_flops(N, nx, nu, 1)
                                                                   - riccati_flops(N, nx, nu, 0))
    bound_ms, bound_by = bound(n_bytes, flops)
    print(f"K4 batch of {n} (H1, N={N}, the fleet chunk's inputs; {smi_line}): {ms:.4f} "
          f"ms/launch (one instance at N=25: {k4['ms_n25']:.4f}; vmapped plain {plain_ms:.3f} "
          f"ms; vmapped "
          f"solver.backward_pass {loop_ms:.3f} ms; bound {bound_ms:.6e} ms by {bound_by}: "
          f"{n_bytes} bytes, {flops} flop; PD bumps {int(bumped.sum())})")
    k4.update(takes=f"nx <= {riccati.MAX_NX}, nu <= {riccati.MAX_NU}; a batch of instances in "
                    f"one launch (one block or cluster each)", ms_batch128_n25=ms,
              plain_ms_batch128_n25=plain_ms, vmapped_loop_ms_batch128_n25=loop_ms,
              bound_ms_batch128_n25=bound_ms)


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

    k4_err = riccati_cases([c for c in RICCATI_CASES if c[1] <= 64 and c[2] <= 32], cfg.pd_bump)

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
    *p64, bumped = riccati.backward_pass_plain(*a64, lcfg.reg_init, pd, with_bumps=True)
    bump_steps = bumped.nonzero().flatten().tolist()  # the work this data needs
    # K (|K| up to ~1e3) and kff have float32 floors far apart, so each is held to its own bar.
    lh_err = {}
    for j, out in enumerate(("K", "kff")):
        e_k, e_p, e_kp = max_err(got[j], p64[j]), max_err(p32[j], p64[j]), max_err(got[j], p32[j])
        bar = RICCATI_ATOL + 2.0 * e_p
        lh_err[out] = (e_k, e_p)
        print(f"K4 on the long-horizon inputs (N={lcfg.N}), {out}: |kernel-plain64| {e_k:.3e}, "
              f"|plain32-plain64| {e_p:.3e}, "
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
    lh_ms = {}
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
        lh_ms[label] = (time.perf_counter() - t1) * 1e3 / n_steps
        print(f"{label}: {lh_ms[label]:.2f} ms per control step "
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
    batched = batched_phase(report, smi_line, reset_counts, read_counts)
    phase("batched", t0)

    # ---- 9. the reference's exact-derivative solver ----------------------------
    t0 = time.perf_counter()
    exact_phase(report, smi_line, reset_counts, read_counts)
    phase("exact", t0)

    # ---- 10. shards and scans: the sharded solve and fleet, assoc, quat FK ----
    t0 = time.perf_counter()
    shards_phase(report, smi_line, reset_counts, read_counts, dict(
        standing=(model, cp, cfg, refs, plan), lh_args=lh_args, A=A_, B=B_, quad=lq, reg=reg_t,
        pd=pd, p64=p64, k4_err={k: v[0] for k, v in lh_err.items()}, lh_ms=lh_ms))
    phase("shards", t0)

    # ---- 11. K4 at every input: the hands model and the batch grid ------------
    t0 = time.perf_counter()
    k4_phase(report, smi_line, reset_counts, read_counts, batched)
    phase("k4 at every input", t0)

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
