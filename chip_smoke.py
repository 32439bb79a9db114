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
              tests' model; on the main path's model against float64, at
              atol 2e-4 over the first two steps from standing (the stiction
              regime) and, over N=25, no further than float32 allows; then
              timed with CUDA events
  4. loop     config.yaml with the standing references: 15 MPC steps of
              run_closed_loop on the card in float32, held to finite states,
              every solve_ok, base z in (1.0, 1.1), last cost below the
              first, and K1/K2 launched; then timed once more
Then one `kernels` JSON line and, last, the `ok` JSON line. Any failed
check exits non-zero before the result lines. Imports only the port, torch,
numpy and the standard library.
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


def bound(n_bytes, n_flops):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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
    print(smi.stdout.strip().splitlines()[0])
    phase("device", t0)

    sys.path.insert(0, ROOT)
    from mpc_ilqr_tpu_torch.dynamics import engine
    from mpc_ilqr_tpu_torch.io.config import load_config
    from mpc_ilqr_tpu_torch.models.robot import load_h1, standing_state
    from mpc_ilqr_tpu_torch.mpc import controller, runner
    from mpc_ilqr_tpu_torch.ops import _build
    from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk
    from mpc_ilqr_tpu_torch.ops.step_plan import build_step_plan

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"nvcc build: {_build.build_log['seconds']:.2f} s -> {_build.build_log['path']}")
    for line in _build.build_log["ptxas"]:
        print(f"  {line}")
    phase("build", t0)

    # ---- 3. kernels against their plain versions ---------------------------
    t0 = time.perf_counter()
    app = load_config(os.path.join(ROOT, "config.yaml"))
    app.q_ref_path = "data/q_standing.csv"
    app.v_ref_path = "data/v_standing.csv"
    app.contact_schedule_path = "data/contact_standing.csv"
    prob = runner.setup(app)  # device "cuda", float32
    model, cp, cfg, refs, plan = prob.model, prob.cp, prob.cfg, prob.refs, prob.plan
    if plan is None or model.device.type != "cuda":
        fail("setup did not place the problem and its kernel plan on the card")
    N, nx, nu, dev = cfg.N, model.nx, model.nu, model.device
    smem = lib.mpc_smem_bytes(plan.fbuf.numel(), plan.ibuf.numel(), plan.B, plan.nq, plan.nv,
                              plan.nu, plan.ncp)
    print(f"shared memory per block (H1): {smem} bytes; packed model "
          f"{4 * (plan.fbuf.numel() + plan.ibuf.numel())} bytes")
    tpu_id = {"rollout": "K1", "linesearch": "K2", "linesearch_batched": "K3"}
    replaces = {"rollout": "mpc_ilqr_tpu/ops/rollout_kernel.py:61",
                "linesearch": "mpc_ilqr_tpu/ops/rollout_kernel.py:108",
                "linesearch_batched": "mpc_ilqr_tpu/ops/rollout_kernel.py:208"}

    def kernel_cases(m, p, N=N):
        """(kernel, plain, A, feedback) per entry point at the main path's
        shapes (H1, N=25 unless given; A=1 and the 7 fallback alphas), inputs
        from a fixed seed as in tests/test_ops.py:181-193."""
        rng = np.random.default_rng(0)
        t32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev).contiguous()
        x0 = standing_state(m)
        u_grav = engine.gravity_comp(m, x0)
        us_grav = u_grav[None].repeat(N, 1).contiguous()
        ubar = (u_grav[None] + t32(0.1 * rng.normal(0, 1, (N, nu)))).contiguous()
        xbar = rk.rollout_plain(m, x0, ubar).contiguous()
        K = t32(0.01 * rng.normal(0, 1, (N, nu, nx)))
        kff = t32(0.1 * rng.normal(0, 1, (N, nu)))
        a1, a7 = t32(cfg.alphas[:1]), t32(cfg.alphas[1:])
        ls = (x0, xbar, ubar, K, kff)
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
    model64 = model.to(dtype=torch.float64)
    report = {}
    for name in ref_cases:
        kern, plain, _, _ = ref_cases[name]
        err = max_err(kern(), plain())
        print(f"{tpu_id[name]} {rk.CUDA_KERNEL[name]} (reference test model): "
              f"max|kernel - plain| = {err:.3e} (atol {ATOL})")
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
        model_bytes = 4 * (plan.fbuf.numel() + plan.ibuf.numel())
        flops = chain_flops(model, got[0][:, :-1] if feedback else got[:-1], feedback)
        n_bytes = 4 * (n_in + n_out) + model_bytes
        bound_ms, bound_by = bound(n_bytes, flops)
        print(f"  {ms:.4f} ms/launch (plain {plain_ms:.3f} ms; bound {bound_ms:.6f} ms by "
              f"{bound_by}: {n_bytes} bytes, {flops} flop)")
        report[name] = dict(name=f"{tpu_id[name]} {rk.CUDA_KERNEL[name]}", route="cuda",
                            source="mpc_ilqr_tpu_torch/csrc/rollout.cu",
                            replaces=replaces[name], launches=0, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=None, bytes=n_bytes, flops=flops,
                            stiction_err_vs_f64=e_s, main_model_err_vs_f64=e_k,
                            main_model_plain32_err_vs_f64=e_p)
    phase("kernels", t0)
    if "--kernels" in sys.argv[1:]:
        return 0

    # ---- 4. the closed loop ------------------------------------------------
    t0 = time.perf_counter()
    x_init = standing_state(model)
    rk.reset_launch_counts()
    _, xT, hist = controller.run_closed_loop(model, cp, cfg, refs, controller.init_state(model, cfg),
                                             x_init, N_STEPS, plan=plan)
    torch.cuda.synchronize()
    launches = dict(rk.LAUNCHES)
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

    t1 = time.perf_counter()
    controller.run_closed_loop(model, cp, cfg, refs, controller.init_state(model, cfg), x_init,
                               N_STEPS, plan=plan)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) * 1e3 / N_STEPS
    print(f"closed loop: {step_ms:.2f} ms per MPC step (host clock, warm, {N_STEPS} steps)")

    # Where one solver iteration's time goes, at the last step's window.
    from mpc_ilqr_tpu_torch.costs.quadratics import quadraticize_gn, trajectory_costs
    from mpc_ilqr_tpu_torch.costs.references import extract_window
    from mpc_ilqr_tpu_torch.ilqr import solver

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
    for label, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        print(f"  breakdown: {label}: {(time.perf_counter() - t2) * 1e3 / 5:.3f} ms (host clock)")
    phase("loop", t0)

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
