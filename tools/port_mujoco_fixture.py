"""The JAX package's own MuJoCo-in-the-loop runs, computed on the CPU and
saved to tests/torch_fixtures/mujoco_h1.npz.

    JAX_PLATFORMS=cpu python tools/port_mujoco_fixture.py

tests/test_mujoco_in_the_loop.py's two settings, line for line: the
standing references for 10 steps and config.yaml as shipped (walking) for
12 steps, each with N=8 and max_iterations 3, through
mpc_ilqr_tpu.mpc.mujoco_plant.run_mujoco_in_the_loop (the controller plans
with the differentiable engine, MuJoCo with the reference's solver settings
is the plant). It saves each run's history (x, u, cost).
tests/test_torch_mujoco_plant.py holds the port's runs to it. Needs
mujoco; compiling the controller takes about a minute per run on one core.
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

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from port_fixture_sources import stamp  # noqa: E402

from mpc_ilqr_tpu.io.config import load_config  # noqa: E402
from mpc_ilqr_tpu.mpc import runner  # noqa: E402
from mpc_ilqr_tpu.mpc.mujoco_plant import run_mujoco_in_the_loop  # noqa: E402

OUT = os.path.join(ROOT, "tests", "torch_fixtures", "mujoco_h1.npz")
SMALL = dict(N=8, max_iterations=3)  # tests/test_mujoco_in_the_loop.py
RUNS = {"standing": 10, "walking": 12}


def main():
    out = {}
    for name, steps in RUNS.items():
        app = load_config(os.path.join(ROOT, "config.yaml"))
        if name == "standing":
            app.q_ref_path = "data/q_standing.csv"
            app.v_ref_path = "data/v_standing.csv"
            app.contact_schedule_path = "data/contact_standing.csv"
        prob = runner.setup(app)
        prob = prob._replace(cfg=dataclasses.replace(prob.cfg, **SMALL))
        hist = run_mujoco_in_the_loop(prob, steps)
        out.update({f"{name}_{k}": np.stack(v) if k != "cost" else np.asarray(v)
                    for k, v in hist.items()})
        print(f"{name}: {steps} steps, cost {hist['cost'][0]:.4f} -> {hist['cost'][-1]:.4f}, "
              f"base z min {min(x[2] for x in hist['x']):.4f}")
    arrays = {k: np.asarray(v) for k, v in out.items()}
    np.savez_compressed(OUT, **stamp(arrays, "tools/port_mujoco_fixture.py"))
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
