"""Reference outputs of the JAX package for the port's slowest parity tests,
computed on the CPU and saved under tests/torch_fixtures/:

    JAX_PLATFORMS=cpu python tools/port_parity_fixture.py

  slice_h1.npz         tests/test_torch_slice.py::test_closed_loop_matches_reference:
                       3 MPC steps of run_closed_loop on the standing
                       flagship, float32, N=6, max_iterations 3,
                       structured_frozen_mass + gn + cascade
  walking_h1.npz       tests/test_torch_runner.py's walking run:
                       runner.run_simulation on config.yaml as shipped, N=6,
                       max_iterations 3, 3 sim steps, float32, with the
                       package's step and trajectory loggers (their headers
                       and rows are saved) and each step's solve_ok
  long_horizon_h1.npz  tests/test_torch_long_horizon.py::
                       test_amortized_long_horizon_loop_matches_reference:
                       bench_suite's _tvlqr_amortized_loop on the tuned
                       long-horizon set-up at N=6, one iteration, backward
                       "pallas" (interpret mode), a solve every 2nd of 4
                       control steps, float32
  nominal_h1.npz       tests/test_torch_costs_solver.py's `nominal`: the
                       rollout at seeded controls, its A/B
                       (structured_frozen_mass), GN quadratics, backward pass
                       and cost on the standing window at N=5, float64; the
                       line search in each mode with that feedback law, and
                       the GN quadratics on the window clamped at t=196

Each set-up is the test's own, line for line; the tests keep their port
side, their comparisons and their tolerances. Each file is stamped with the
digest of the JAX sources imported (tools/port_fixture_sources.py).
Compiling the four graphs takes several minutes on one core, which is why
the suite reads the files instead of running them.
"""
import dataclasses
import functools
import os
import sys
import tempfile
import types

# conftest.py's XLA:CPU settings, so that the graphs compile as the suite's did
os.environ["XLA_FLAGS"] = " ".join([os.environ.get("XLA_FLAGS", ""),
                                    "--xla_force_host_platform_device_count=8",
                                    "--xla_backend_optimization_level=0"]).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from bench_suite import _tvlqr_amortized_loop  # noqa: E402
from port_fixture_sources import stamp  # noqa: E402

from mpc_ilqr_tpu.costs.params import build_cost_params  # noqa: E402
from mpc_ilqr_tpu.costs.quadratics import quadraticize, trajectory_cost  # noqa: E402
from mpc_ilqr_tpu.costs.references import extract_window  # noqa: E402
from mpc_ilqr_tpu.ilqr import solver as jsol  # noqa: E402
from mpc_ilqr_tpu.io import logging as iolog  # noqa: E402
from mpc_ilqr_tpu.io.config import load_config  # noqa: E402
from mpc_ilqr_tpu.io.references import load_reference_set  # noqa: E402
from mpc_ilqr_tpu.models.robot import load_h1, standing_state  # noqa: E402
from mpc_ilqr_tpu.mpc import controller, runner  # noqa: E402

OUT = os.path.join(ROOT, "tests", "torch_fixtures")
CONFIG = os.path.join(ROOT, "config.yaml")
STANDING = ("q_standing.csv", "v_standing.csv", "contact_standing.csv")
# tests/test_torch_common.py's H1_KW: the contact of config.yaml's engine section.
H1_KW = dict(gravity=(0.0, 0.0, -1.0), timestep=0.02, contact_stiffness=5000.0,
             contact_damping=300.0, contact_impratio=100.0)
SLICE_SOLVER = dict(N=6, max_iterations=3, linearization="structured_frozen_mass",
                    quad_mode="gn", line_search="cascade")  # tests/test_torch_slice.py
WALK_SMALL, WALK_STEPS = dict(N=6, max_iterations=3), 3  # tests/test_torch_runner.py
LH_TUNED = dict(max_iterations=2, inner_attempts=1, linearize_every=2, outer_loop="scan")
NOMINAL_N = 5  # tests/test_torch_costs_solver.py


def save(name, out):
    path = os.path.join(OUT, name)
    arrays = stamp({k: np.asarray(v) for k, v in out.items()}, "tools/port_parity_fixture.py")
    np.savez_compressed(path, **arrays)
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")


def standing_app():
    app = load_config(CONFIG)
    app.q_ref_path, app.v_ref_path, app.contact_schedule_path = (f"data/{f}" for f in STANDING)
    return app


def slice_run():
    app = load_config(CONFIG)
    jm = load_h1(gravity=tuple(app.mpc.gravity), timestep=0.02, dtype=jnp.float32)
    cp = build_cost_params(jm, app.mpc.cost_weights, app.mpc.constraints, dtype=jnp.float32)
    refs = load_reference_set(jm, *(os.path.join(ROOT, "data", f) for f in STANDING),
                              dtype=jnp.float32)
    cfg = jsol.ILQRConfig(**SLICE_SOLVER)
    run = jax.jit(functools.partial(controller.run_closed_loop, jm, cp, cfg, n_steps=3))
    _, xT, h = run(refs, controller.init_state(jm, cfg), standing_state(jm))
    print(f"slice: iterations {np.asarray(h['iterations'])}, cost {np.asarray(h['cost'])}")
    return dict(xT=xT, **{k: h[k] for k in ("x", "u", "cost", "iterations", "solve_ok")})


def walking_run():
    prob = runner.setup(load_config(CONFIG))
    prob = prob._replace(cfg=dataclasses.replace(prob.cfg, **WALK_SMALL))
    m, oks = prob.model, []
    inner = jax.block_until_ready

    def wait(out):  # chip_smoke.recording_waits: each step's solve_ok
        out = inner(out)
        if isinstance(out, tuple) and len(out) == 3 and hasattr(out[2], "solve_ok"):
            oks.append(bool(out[2].solve_ok))
        return out

    with tempfile.TemporaryDirectory() as d:
        jax.block_until_ready = wait
        try:
            hist, state = runner.run_simulation(
                prob, sim_steps=WALK_STEPS, verbose=False,
                step_logger=iolog.StepLogger(os.path.join(d, "logs", "mpc_log.csv"), m.nx, m.nu),
                traj_logger=iolog.OptimalTrajectoryLogger(os.path.join(d, "results"), m.nq, m.nu))
        finally:
            jax.block_until_ready = inner
        out = dict(refs_length=prob.refs.length, t_idx=int(state.t_idx), solve_ok=np.array(oks),
                   hist_keys=np.array(sorted(hist)),
                   **{k: np.stack(hist[k]) if k in ("x", "u") else np.asarray(hist[k])
                      for k in ("x", "u", "cost", "iterations", "solve_ms")})
        for name, p in (("log", "logs/mpc_log.csv"), ("q", "results/q_optimal.csv"),
                        ("u", "results/u_optimal.csv")):
            with open(os.path.join(d, p)) as f:
                out[f"{name}_header"] = f.readline().rstrip("\n")
            out[f"{name}_rows"] = np.atleast_2d(np.loadtxt(os.path.join(d, p), delimiter=",",
                                                           skiprows=1))
    print(f"walking: iterations {out['iterations']}, solve_ok {oks}, cost {out['cost']}")
    return out


def long_horizon_run():
    app = standing_app()
    app.mpc.dt = 0.01
    app.mpc.physics_dt = 0.01
    app.mpc.horizon = 100
    jprob = runner.setup(app)
    N, k, n_steps = 6, 2, 4
    jcfg = dataclasses.replace(jprob.cfg, **{**LH_TUNED, "max_iterations": 1}, backward="pallas",
                               N=N)
    jp = types.SimpleNamespace(model=jprob.model, cp=jprob.cp, cfg=jcfg, refs=jprob.refs,
                               plan=None)
    run = jax.jit(functools.partial(_tvlqr_amortized_loop(jp, k), n_steps=n_steps))
    state, xT, h = run(jprob.refs, controller.init_state(jprob.model, jcfg),
                       standing_state(jprob.model))
    print(f"long horizon: solve_ok {np.asarray(h['solve_ok'])}, cost {np.asarray(h['cost'])}")
    return dict(xT=xT, t_idx=state.t_idx, prev_xbar=state.prev_xbar, prev_ubar=state.prev_ubar,
                solve_ok=h["solve_ok"], cost=h["cost"])


def nominal_run():
    f64 = jnp.float64
    app = load_config(CONFIG)
    jm = load_h1(dtype=f64, **H1_KW)
    cp = build_cost_params(jm, app.mpc.cost_weights, app.mpc.constraints, dtype=f64)
    refs = load_reference_set(jm, *(os.path.join(ROOT, "data", f) for f in STANDING), dtype=f64)
    N = NOMINAL_N
    rng = np.random.default_rng(11)  # tests/test_torch_costs_solver.py's `prob`
    xs = np.zeros((N + 1, jm.nx))
    xs[:, 2], xs[:, 3] = 1.0, 1.0
    xs += 0.02 * rng.normal(size=xs.shape)
    us = rng.normal(0, 2.0, (N, jm.nu))
    win = extract_window(refs, 0, N)
    cfg = jsol.ILQRConfig(N=N, linearization="structured_frozen_mass", quad_mode="gn")

    @jax.jit
    def ref(x0, ubar):
        xbar = jsol.rollout(jm, cfg, x0, ubar)
        A, B = jsol.linearize(jm, cfg, xbar, ubar)
        q = quadraticize(jm, cp, win, xbar, ubar, hess_mode="gn")
        K, kff = jsol.backward_pass(A, B, q, jnp.asarray(1e-6), 1e-4)
        return xbar, A, B, q, K, kff, trajectory_cost(jm, cp, win, xbar, ubar)

    xbar, A, B, q, K, kff, cost = ref(jnp.asarray(xs[0]), jnp.asarray(us))
    print(f"nominal: cost {float(cost):.6f}")
    out = dict(xs=xs, us=us, xbar=xbar, A=A, B=B, K=K, kff=kff, cost=cost,
               **{f"q_{f}": getattr(q, f) for f in q._fields})
    # test_line_search_selects_like_reference: each mode with the nominal's feedback law
    for mode in ("first_accept", "argmin", "cascade"):
        cfg_j = jsol.ILQRConfig(N=N, line_search=mode)
        res = jax.jit(lambda *a: jsol.line_search(jm, cp, cfg_j, win, *a))(
            jnp.asarray(xs[0]), xbar, jnp.asarray(us), K, kff, cost)
        out.update({f"ls_{mode}_{k}": v for k, v in zip(("ok", "xs", "us", "cost", "best"), res)})
    # test_quadraticize_gn_on_a_clamped_window: the window at t=196 of the 200-row track
    win196 = extract_window(refs, 196, N)
    q196 = jax.jit(lambda a, b: quadraticize(jm, cp, win196, a, b, hess_mode="gn"))(
        jnp.asarray(xs), jnp.asarray(us))
    out.update({f"q196_{f}": getattr(q196, f) for f in q196._fields})
    return out


def main():
    only = set(sys.argv[1:])
    runs = {"slice_h1.npz": slice_run, "walking_h1.npz": walking_run,
            "long_horizon_h1.npz": long_horizon_run, "nominal_h1.npz": nominal_run}
    for name, fn in runs.items():
        if not only or name in only:
            save(name, fn())


if __name__ == "__main__":
    main()
