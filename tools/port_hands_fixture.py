"""Reference outputs of the JAX package on H1 with hands (nx=103, nu=45) for
tests/test_torch_hands.py, computed on the CPU and saved to
tests/torch_fixtures/hands_h1.npz.

    JAX_PLATFORMS=cpu python tools/port_hands_fixture.py

The problem is chip_smoke.hands_problem's, built here from the JAX
package's own entry points: load_robot(h1_with_hand.xml) with the ankles as
end effectors, config.yaml's gravity and dt 0.02; build_cost_params with
config.yaml's weights; config.yaml's solver (structured_frozen_mass, gn,
cascade, max_iterations 4, tolerance 1e-3) with backward "pallas"; the
standing state held as the references (build_reference_set, stance 0).
Cut to N=5 (N=25 in chip_smoke): compiling the engine on the 46-body tree
takes minutes on one core. It saves, in float64 along the cold-start
rollout from standing at gravity compensation:

  A, B         linearize (structured_frozen_mass)
  lx .. luu    quadraticize with hess_mode "gn"
  K, kff       backward_pass_pallas(interpret=True) on float32 copies of
               A, B and the quadratics, λ = reg_init
  solve_*      a 2-iteration solve from that start with backward "pallas"
               (its kernel in interpret mode, as the solve picks on the
               CPU; no StepPlan, so the plain rollout and line-search
               chains), float64 around the kernel's float32

stamped with the digest of the JAX sources it imported
(tools/port_fixture_sources.py).
"""
import dataclasses
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

from mpc_ilqr_tpu.costs.params import build_cost_params  # noqa: E402
from mpc_ilqr_tpu.costs.quadratics import quadraticize  # noqa: E402
from mpc_ilqr_tpu.costs.references import extract_window  # noqa: E402
from mpc_ilqr_tpu.dynamics import engine  # noqa: E402
from mpc_ilqr_tpu.ilqr import solver as ilqr  # noqa: E402
from mpc_ilqr_tpu.io.config import load_config  # noqa: E402
from mpc_ilqr_tpu.io.references import build_reference_set  # noqa: E402
from mpc_ilqr_tpu.models.robot import load_robot, standing_state  # noqa: E402
from mpc_ilqr_tpu.ops.riccati import backward_pass_pallas  # noqa: E402

OUT = os.path.join(ROOT, "tests", "torch_fixtures", "hands_h1.npz")
# chip_smoke.HANDS_XML, HANDS_EE
HANDS_XML = os.path.join("robots", "h1_description", "mjcf", "h1_with_hand.xml")
HANDS_EE = ("left_ankle_link", "right_ankle_link")
N, DT, SOLVE_ITERATIONS = 5, 0.02, 2
SOL_FIELDS = ("xbar", "ubar", "K", "kff", "cost", "iterations", "reg", "success")


def hands_problem(n, dt, dtype):
    """chip_smoke.hands_problem in the JAX package (no StepPlan)."""
    app = load_config(os.path.join(ROOT, "config.yaml"))
    model = load_robot(os.path.join(ROOT, HANDS_XML), ee_body_names=HANDS_EE,
                       gravity=tuple(app.mpc.gravity), timestep=dt, dtype=dtype)
    cp = build_cost_params(model, app.mpc.cost_weights, app.mpc.constraints, dtype=dtype)
    e = app.engine
    cfg = ilqr.ILQRConfig(N=n, max_iterations=int(e["max_iterations"]),
                          tolerance=float(e["tolerance"]), cost_mode=e["cost_mode"],
                          line_search=e["line_search"], backward="pallas",
                          linearization=e["linearization"], rollout_backend=e["rollout_backend"],
                          ls_backend=e["ls_backend"], quad_mode=e["quad_mode"])
    q0 = np.asarray(standing_state(model))[:model.nq].astype(np.float64)
    refs = build_reference_set(model, np.tile(q0, (n + 1, 1)), np.zeros((n + 1, model.nv)),
                               np.zeros((n + 1, len(HANDS_EE))), dtype=dtype)
    return model, cp, cfg, refs


def main():
    model, cp, cfg, refs = hands_problem(N, DT, jnp.float64)
    x0 = standing_state(model)
    us = jnp.tile(engine.gravity_comp(model, x0)[None], (N, 1))
    win = extract_window(refs, jnp.zeros((), jnp.int32), N)
    xs = jax.jit(lambda u: ilqr.rollout(model, cfg, x0, u))(us)
    A, B = jax.jit(lambda x, u: ilqr.linearize(model, cfg, x, u))(xs, us)
    q = jax.jit(lambda x, u: quadraticize(model, cp, win, x, u, hess_mode="gn"))(xs, us)
    out = dict(x0=x0, us=us, xs=xs, A=A, B=B, lx=q.lx, lu=q.lu, lxx=q.lxx, luu=q.luu,
               reg=cfg.reg_init, pd_bump=cfg.pd_bump, N=N, dt=DT,
               nq=model.nq, nv=model.nv, nu=model.nu, ncp=model.ncp)
    f32 = [a.astype(jnp.float32) for a in (A, B, q.lx, q.lu, q.lxx, q.luu)]
    out["K"], out["kff"] = backward_pass_pallas(*f32, jnp.float32(cfg.reg_init), cfg.pd_bump,
                                                interpret=True)
    scfg = dataclasses.replace(cfg, max_iterations=SOLVE_ITERATIONS)
    sol = jax.block_until_ready(jax.jit(
        lambda u: ilqr.solve(model, cp, scfg, x0, win, u))(us))
    out.update({f"solve_{f}": getattr(sol, f) for f in SOL_FIELDS})
    print(f"hands: nq {model.nq}, nv {model.nv}, nu {model.nu}, ncp {model.ncp}; solve: cost "
          f"{float(sol.cost)}, iterations {int(sol.iterations)}, success {bool(sol.success)}")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    arrays = {k: np.asarray(v) for k, v in out.items()}
    np.savez_compressed(OUT, **stamp(arrays, "tools/port_hands_fixture.py"))
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
