"""Reference outputs of the JAX package for tests/test_torch_exact.py's H1
cases, computed on the CPU in float64 and saved to
tests/torch_fixtures/exact_h1.npz.

    JAX_PLATFORMS=cpu python tools/port_exact_fixture.py

The problem is the standing flagship of tests/test_torch_common.py
(`standing_problem`: config.yaml's weights, H1 with the contact of its
engine section, the standing references) at N=4, with seeded draws:

  linearize     "ad", "ad_frozen_mass" and "fd" (fd_eps 1e-5) along the
                rollout of u_grav + 0.5 N(0, 1) from a perturbed standing
                state
  costs         on a random window (tests/test_costs.py:_random_window's
                recipe: mixed stance, so every gated term is live): exact
                quadraticize, trajectory_cost in "reference" and "full"
                mode, and each term of stage_cost_full / terminal_cost_full
                at each knot, separately
  mpc           2 MPC steps of step_once with "ad" + "exact", the cascade
                with its phase 1 on "xla", from the standing state

It saves the draws, the config (as JSON) and every output, stamped with
the digest of the JAX sources it imported (tools/port_fixture_sources.py).
Compiling the exact Hessian of H1's full stage cost takes minutes on one
core, which is why the suite reads the file instead of running it.
"""
import json
import os
import sys

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

from port_fixture_sources import stamp  # noqa: E402

from mpc_ilqr_tpu.costs import terms  # noqa: E402
from mpc_ilqr_tpu.costs.params import build_cost_params  # noqa: E402
from mpc_ilqr_tpu.costs.quadratics import quadraticize, trajectory_cost  # noqa: E402
from mpc_ilqr_tpu.costs.references import ReferenceWindow  # noqa: E402
from mpc_ilqr_tpu.dynamics import engine  # noqa: E402
from mpc_ilqr_tpu.ilqr import solver as ilqr  # noqa: E402
from mpc_ilqr_tpu.io.config import load_config  # noqa: E402
from mpc_ilqr_tpu.io.references import load_reference_set  # noqa: E402
from mpc_ilqr_tpu.models.robot import load_h1, standing_state  # noqa: E402
from mpc_ilqr_tpu.mpc import controller  # noqa: E402

OUT = os.path.join(ROOT, "tests", "torch_fixtures", "exact_h1.npz")
# tests/test_torch_common.py's H1_KW: the contact of config.yaml's engine section.
H1_KW = dict(gravity=(0.0, 0.0, -1.0), timestep=0.02, contact_stiffness=5000.0,
             contact_damping=300.0, contact_impratio=100.0)
N = 4
LIN_MODES = ("ad", "ad_frozen_mass", "fd")
MPC_CFG = dict(N=N, max_iterations=3, tolerance=1e-3, linearization="ad", quad_mode="exact",
               line_search="cascade", cascade_p1_backend="xla")
MPC_STEPS = 2
STATE_FIELDS = ("t_idx", "prev_xbar", "prev_ubar", "prev_K", "has_prev", "reg")
DIAG_FIELDS = ("cost", "iterations", "reg", "solve_ok")
WIN_FIELDS = ("x", "u", "com", "com_vel", "ee_pos", "stance")


def stage_terms(model, cp, x, u, x_ref, u_ref, com, com_vel, ee, stance):
    """Each term of stage_cost_full at one knot, and their sum."""
    return dict(
        tracking=terms.tracking_cost(cp, x, x_ref, u, u_ref, model=model),
        com=terms.com_cost(model, cp, x, com), com_vel=terms.com_vel_cost(model, cp, x, com_vel),
        ee_pos=terms.ee_pos_cost(model, cp, x, ee, stance),
        ee_vel=terms.ee_vel_cost(model, cp, x, stance), upright=terms.upright_cost(cp, x),
        balance=terms.balance_cost(model, cp, x, ee, stance),
        balance_base_vel=terms.balance_cost(model, cp, x, ee, stance, base_vel_approx=True),
        joint_limit=terms.joint_limit_cost(model, cp, x),
        torque_limit=terms.torque_limit_cost(model, cp, u),
        full=terms.stage_cost_full(model, cp, x, u, x_ref, u_ref, com, com_vel, ee, stance),
        eval_reference=terms.stage_cost_eval(model, cp, x, u, x_ref, u_ref, com, com_vel, ee,
                                             stance, mode="reference"))


def terminal_terms(model, cp, x, x_ref, com, com_vel, ee, stance):
    return dict(
        tracking=terms.tracking_cost(cp, x, x_ref, terminal=True, model=model),
        com=terms.com_cost(model, cp, x, com), ee_pos=terms.ee_pos_cost(model, cp, x, ee, stance),
        ee_vel=terms.ee_vel_cost(model, cp, x, stance), upright=terms.upright_cost(cp, x),
        balance=terms.balance_cost(model, cp, x, ee, stance),
        joint_limit=terms.joint_limit_cost(model, cp, x),
        full=terms.terminal_cost_full(model, cp, x, x_ref, com, com_vel, ee, stance),
        eval_reference=terms.terminal_cost_eval(model, cp, x, x_ref, com, com_vel, ee, stance,
                                                mode="reference"))


def main():
    f64 = jnp.float64
    app = load_config(os.path.join(ROOT, "config.yaml"))
    model = load_h1(dtype=f64, **H1_KW)
    cp = build_cost_params(model, app.mpc.cost_weights, app.mpc.constraints, dtype=f64)
    refs = load_reference_set(model, *(os.path.join(ROOT, "data", f) for f in (
        "q_standing.csv", "v_standing.csv", "contact_standing.csv")), dtype=f64)
    nq, nv, nu = model.nq, model.nv, model.nu
    rng = np.random.default_rng(0)
    out = {"mpc_cfg": json.dumps(MPC_CFG)}

    # linearize along a rollout
    x0 = np.asarray(standing_state(model)).copy()
    x0[7:nq] += rng.normal(0, 0.05, nq - 7)
    x0[nq:] += rng.normal(0, 0.1, nv)
    us = np.asarray(engine.gravity_comp(model, jnp.asarray(x0)))[None] + rng.normal(0, 0.5, (N, nu))
    cfg0 = ilqr.ILQRConfig(N=N)
    xbar = jax.jit(lambda a, b: ilqr.rollout(model, cfg0, a, b))(jnp.asarray(x0), jnp.asarray(us))
    out.update(lin_x0=x0, lin_us=us, lin_xbar=xbar)
    for mode in LIN_MODES:
        cfg = ilqr.ILQRConfig(N=N, linearization=mode)
        A, B = jax.jit(lambda a, b: ilqr.linearize(model, cfg, a, b))(xbar, jnp.asarray(us))
        out[f"lin_{mode}_A"], out[f"lin_{mode}_B"] = A, B
        print(f"linearize {mode}: max|A| {float(jnp.abs(A).max()):.4f}")

    # costs on a random window with mixed stance (tests/test_costs.py:_random_window)
    xs = x0[None] + 0.02 * rng.standard_normal((N + 1, model.nx))
    uw = 2.0 * rng.standard_normal((N, nu))
    win = dict(x=x0[None] + 0.01 * rng.standard_normal((N + 1, model.nx)),
               u=0.5 * rng.standard_normal((N, nu)),
               com=np.array([0.0, 0.0, 1.0]) + 0.01 * rng.standard_normal((N + 1, 3)),
               com_vel=0.05 * rng.standard_normal((N + 1, 3)),
               ee_pos=0.2 * rng.standard_normal((N + 1, 2, 3)),
               stance=rng.integers(0, 2, (N + 1, 2)).astype(np.float64))
    win["stance"][0] = (1.0, 1.0)  # every stance pattern: both, one, none
    win["stance"][1] = (0.0, 0.0)
    win["stance"][2] = (1.0, 0.0)
    out.update(cost_xs=xs, cost_us=uw, **{f"win_{k}": v for k, v in win.items()})
    jwin = ReferenceWindow(**{k: jnp.asarray(v) for k, v in win.items()})
    q = jax.jit(lambda a, b: quadraticize(model, cp, jwin, a, b))(jnp.asarray(xs), jnp.asarray(uw))
    out.update({f"quad_{k}": getattr(q, k) for k in q._fields})
    for mode in ("reference", "full"):
        out[f"cost_{mode}"] = jax.jit(lambda a, b: trajectory_cost(model, cp, jwin, a, b,
                                                                   mode=mode))(xs, uw)
        print(f"trajectory_cost {mode}: {float(out[f'cost_{mode}']):.6f}")
    jx = lambda k, t: jnp.asarray(win[k][t])
    for t in range(N):
        st = stage_terms(model, cp, jnp.asarray(xs[t]), jnp.asarray(uw[t]), jx("x", t),
                         jx("u", t), jx("com", t), jx("com_vel", t), jx("ee_pos", t),
                         jx("stance", t))
        for k, v in st.items():
            out.setdefault(f"stage_{k}", []).append(v)
    tt = terminal_terms(model, cp, jnp.asarray(xs[N]), jx("x", N), jx("com", N), jx("com_vel", N),
                        jx("ee_pos", N), jx("stance", N))
    out.update({f"terminal_{k}": v for k, v in tt.items()})

    # two MPC steps on the reference's own derivative model
    cfg = ilqr.ILQRConfig(**MPC_CFG)
    step = jax.jit(lambda s, x: controller.step_once(model, cp, cfg, refs, s, x))
    state, x = controller.init_state(model, cfg), standing_state(model)
    for k in range(MPC_STEPS):
        out[f"mpc{k}_x"] = x
        state, u, diag = jax.block_until_ready(step(state, x))
        out.update({f"mpc{k}_state_{f}": getattr(state, f) for f in STATE_FIELDS})
        out.update({f"mpc{k}_diag_{f}": getattr(diag, f) for f in DIAG_FIELDS})
        out[f"mpc{k}_u"] = u
        print(f"mpc step {k}: cost {float(diag.cost):.6f}, iterations {int(diag.iterations)}, "
              f"solve_ok {bool(diag.solve_ok)}")
        x = engine.step(model, x, u)

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    arrays = {k: np.asarray(v) for k, v in out.items()}
    np.savez_compressed(OUT, **stamp(arrays, "tools/port_exact_fixture.py"))
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
