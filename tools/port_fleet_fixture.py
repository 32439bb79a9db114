"""Reference outputs of the JAX package for tests/test_torch_fleet.py's H1
cases, computed on the CPU in float64 and saved to
tests/torch_fixtures/fleet_h1.npz.

    JAX_PLATFORMS=cpu python tools/port_fleet_fixture.py

The problem is the standing flagship of tests/test_torch_common.py
(`standing_problem`: config.yaml's weights, H1 with the contact of its
engine section, the standing references), with two set-ups cut to size:

  fleet  2 domain-randomised instances (randomized_models, PRNGKey(0)), the
         fleet solver of tools/bench_suite.py:354-363 (first_accept, alphas
         (1.0, 0.6, 0.2, 0.05), rollout_solver "masked", inner_attempts 2)
         at N=3 and one iteration: fleet_step_once from fleet_init at the
         standing state (the cold start), then again from the states it
         returns (the warm start)
  seeds  jax.vmap(solve) over 3 warm-start seeds u_grav + 0.5 N(0, 1)
         (PRNGKey(0); tools/bench_suite.py:189-203) with 4 alphas at N=4 and
         2 iterations, first_accept

It saves the draws, the configs (as JSON) and every output, stamped with
the digest of the JAX sources it imported (tools/port_fixture_sources.py).
Compiling the two graphs takes minutes on one core, which is why the suite
reads the file instead of running them.
"""
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from port_fixture_sources import stamp  # noqa: E402

from mpc_ilqr_tpu.costs.params import build_cost_params  # noqa: E402
from mpc_ilqr_tpu.costs.references import extract_window  # noqa: E402
from mpc_ilqr_tpu.dynamics import engine  # noqa: E402
from mpc_ilqr_tpu.ilqr import solver as ilqr  # noqa: E402
from mpc_ilqr_tpu.io.config import load_config  # noqa: E402
from mpc_ilqr_tpu.io.references import load_reference_set  # noqa: E402
from mpc_ilqr_tpu.models.robot import load_h1, standing_state  # noqa: E402
from mpc_ilqr_tpu.parallel import fleet as fleet_mod  # noqa: E402

OUT = os.path.join(ROOT, "tests", "torch_fixtures", "fleet_h1.npz")
# tests/test_torch_common.py's H1_KW: the contact of config.yaml's engine section.
H1_KW = dict(gravity=(0.0, 0.0, -1.0), timestep=0.02, contact_stiffness=5000.0,
             contact_damping=300.0, contact_impratio=100.0)
SHIPPED = dict(tolerance=1e-3, linearization="structured_frozen_mass", quad_mode="gn")
FLEET_CFG = dict(SHIPPED, N=3, max_iterations=1, line_search="first_accept",
                 alphas=(1.0, 0.6, 0.2, 0.05), rollout_solver="masked", inner_attempts=2)
SEED_CFG = dict(SHIPPED, N=4, max_iterations=2, line_search="first_accept",
                alphas=(1.0, 0.5, 0.1, 0.02))
N_FLEET, N_SEEDS = 2, 3
STATE_FIELDS = ("t_idx", "prev_xbar", "prev_ubar", "prev_K", "has_prev", "reg")
DIAG_FIELDS = ("cost", "iterations", "reg", "solve_ok")
SOL_FIELDS = ("xbar", "ubar", "K", "kff", "cost", "iterations", "reg", "success")


def main():
    app = load_config(os.path.join(ROOT, "config.yaml"))
    model = load_h1(dtype=jnp.float64, **H1_KW)
    cp = build_cost_params(model, app.mpc.cost_weights, app.mpc.constraints, dtype=jnp.float64)
    refs = load_reference_set(model, *(os.path.join(ROOT, "data", f) for f in (
        "q_standing.csv", "v_standing.csv", "contact_standing.csv")), dtype=jnp.float64)
    x0 = standing_state(model)
    out = {"fleet_cfg": json.dumps(FLEET_CFG), "seed_cfg": json.dumps(SEED_CFG)}

    # fleet: the draws as randomized_models makes them, then two steps
    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)
    out["mass_scale"] = jax.random.uniform(k1, (N_FLEET,), jnp.float64, 0.8, 1.2)
    out["friction"] = jax.random.uniform(k2, (N_FLEET,), jnp.float64, 0.7, 1.3)
    out["stiff_mult"] = 1.0 + 0.2 * jax.random.uniform(k3, (N_FLEET,), jnp.float64, -1.0, 1.0)
    cfg = ilqr.ILQRConfig(**FLEET_CFG)
    models = fleet_mod.randomized_models(model, key, N_FLEET)
    states = fleet_mod.fleet_init(models, cfg, N_FLEET)
    xs = jnp.tile(x0[None], (N_FLEET, 1))
    out["fleet_x"] = xs
    step = jax.jit(lambda m, s, x: fleet_mod.fleet_step_once(m, cp, cfg, refs, s, x))
    for k in range(2):
        states, us, diag = jax.block_until_ready(step(models, states, xs))
        out.update({f"step{k}_state_{f}": getattr(states, f) for f in STATE_FIELDS})
        out.update({f"step{k}_diag_{f}": getattr(diag, f) for f in DIAG_FIELDS})
        out[f"step{k}_u"] = us
        print(f"fleet step {k}: cost {np.asarray(diag.cost)}, iterations "
              f"{np.asarray(diag.iterations)}, solve_ok {np.asarray(diag.solve_ok)}")

    # seeds: jax.vmap(solve), shared model, x0 and window
    scfg = ilqr.ILQRConfig(**SEED_CFG)
    win = extract_window(refs, jnp.zeros((), jnp.int32), scfg.N)
    u_grav = engine.gravity_comp(model, x0)
    seeds = u_grav[None, None, :] + 0.5 * jax.random.normal(
        jax.random.PRNGKey(0), (N_SEEDS, scfg.N, model.nu), dtype=jnp.float64)
    out["seeds"] = seeds
    sol = jax.block_until_ready(
        jax.jit(jax.vmap(lambda u0: ilqr.solve(model, cp, scfg, x0, win, u0)))(seeds))
    out.update({f"seeds_{f}": getattr(sol, f) for f in SOL_FIELDS})
    print(f"seeds: cost {np.asarray(sol.cost)}, iterations {np.asarray(sol.iterations)}, "
          f"success {np.asarray(sol.success)}")

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    arrays = {k: np.asarray(v) for k, v in out.items()}
    np.savez_compressed(OUT, **stamp(arrays, "tools/port_fleet_fixture.py"))
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
