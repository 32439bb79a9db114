"""The JAX package's own float32 "fd" solve on the standing flagship,
computed on the CPU and saved to tests/torch_fixtures/fd32_h1.npz.

    JAX_PLATFORMS=cpu python tools/port_fd32_fixture.py

config.yaml with the standing references, float32, N=6, the shipped
solver (cascade, quad_mode "gn") on the plain chains (rollout, line search
and the cascade's phase 1 on "xla"), cost_mode "full" and fd_eps 1e-5: two
MPC steps of step_once from the standing state with linearization "fd" and,
beside it, "ad_frozen_mass". It saves each step's state, control, cost,
iterations, solve_ok and λ. tests/test_torch_exact.py holds the port's
outcome to it. Compiling the graphs takes about a minute each on one core.
"""
import dataclasses
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

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from port_fixture_sources import stamp  # noqa: E402

from mpc_ilqr_tpu.dynamics import engine  # noqa: E402
from mpc_ilqr_tpu.io.config import load_config  # noqa: E402
from mpc_ilqr_tpu.models.robot import standing_state  # noqa: E402
from mpc_ilqr_tpu.mpc import controller, runner  # noqa: E402

OUT = os.path.join(ROOT, "tests", "torch_fixtures", "fd32_h1.npz")
SOLVER = dict(N=6, cost_mode="full", quad_mode="gn", fd_eps=1e-5, rollout_backend="xla",
              ls_backend="xla", cascade_p1_backend="xla")
MODES = ("fd", "ad_frozen_mass")
STEPS = 2


def main():
    app = load_config(os.path.join(ROOT, "config.yaml"))
    app.q_ref_path = "data/q_standing.csv"
    app.v_ref_path = "data/v_standing.csv"
    app.contact_schedule_path = "data/contact_standing.csv"
    prob = runner.setup(app)
    m = prob.model
    out = {"solver": json.dumps(SOLVER)}
    for mode in MODES:
        cfg = dataclasses.replace(prob.cfg, linearization=mode, **SOLVER)
        step = jax.jit(lambda s, x: controller.step_once(m, prob.cp, cfg, prob.refs, s, x))
        state, x = controller.init_state(m, cfg), standing_state(m)
        for k in range(STEPS):
            out[f"{mode}{k}_x"] = x
            state, u, diag = jax.block_until_ready(step(state, x))
            out.update({f"{mode}{k}_{f}": getattr(diag, f) for f in diag._fields})
            out[f"{mode}{k}_u"] = u
            out[f"{mode}{k}_prev_ubar"] = state.prev_ubar
            print(f"{mode} step {k}: cost {float(diag.cost):.7f}, iterations "
                  f"{int(diag.iterations)}, solve_ok {bool(diag.solve_ok)}, reg "
                  f"{float(diag.reg):.3e}")
            x = engine.step(m, x, u, cfg.n_substeps)
    arrays = {k: np.asarray(v) for k, v in out.items()}
    np.savez_compressed(OUT, **stamp(arrays, "tools/port_fd32_fixture.py"))
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
