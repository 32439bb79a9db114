"""The port's controller on a real MuJoCo plant (mpc_ilqr_tpu_torch/mpc/mujoco_plant.py)
at tests/test_mujoco_in_the_loop.py:23-62's settings, on the CPU in
float32: standing for 10 steps and config.yaml's walking for 12, N=8,
max_iterations 3. Each run holds the reference test's gates (finite
states, base z above 1.0, |quat w| above 0.99, last cost below the first)
and matches the JAX package's own run of the same loop
(tests/torch_fixtures/mujoco_h1.npz, tools/port_mujoco_fixture.py):
plant states at atol 1e-3, controls at 2e-2 and costs at rtol 2e-4 (a
float32 contact chain closed through MuJoCo; the gaps measured 1.4e-4,
5.2e-3 and 3.7e-5). Then the CLI: `--plant mujoco --cpu --standing
--steps 2`.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("mujoco")

from mpc_ilqr_tpu_torch.io.config import load_config  # noqa: E402
from mpc_ilqr_tpu_torch.mpc import runner  # noqa: E402
from mpc_ilqr_tpu_torch.mpc.mujoco_plant import run_mujoco_in_the_loop  # noqa: E402
from test_torch_common import ROOT  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "mujoco_h1.npz")
RUNS = {"standing": 10, "walking": 12}


@pytest.mark.parametrize("name", list(RUNS))
def test_port_on_the_mujoco_plant_matches_the_reference(name):
    app = load_config(os.path.join(ROOT, "config.yaml"))  # stock: walking
    if name == "standing":
        app.q_ref_path = "data/q_standing.csv"
        app.v_ref_path = "data/v_standing.csv"
        app.contact_schedule_path = "data/contact_standing.csv"
    prob = runner.setup(app, device="cpu")
    prob = prob._replace(cfg=dataclasses.replace(prob.cfg, N=8, max_iterations=3))
    hist = run_mujoco_in_the_loop(prob, RUNS[name])
    assert set(hist) == {"x", "u", "cost"} and len(hist["x"]) == RUNS[name]
    xs = np.stack(hist["x"])
    assert xs.dtype == np.float64 and np.isfinite(xs).all()
    assert xs[:, 2].min() > 1.0, f"base sagged to {xs[:, 2].min():.3f} on the MuJoCo plant"
    assert np.abs(xs[:, 3]).min() > 0.99, "base tipped on the MuJoCo plant"
    assert hist["cost"][-1] < hist["cost"][0]
    fx = np.load(FIXTURE)
    np.testing.assert_allclose(xs, fx[f"{name}_x"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.stack(hist["u"]), fx[f"{name}_u"], rtol=0, atol=2e-2)
    np.testing.assert_allclose(np.array(hist["cost"]), fx[f"{name}_cost"], rtol=2e-4)


def test_cli_runs_the_mujoco_plant(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "mpc_ilqr_tpu_torch.run_mpc", "--plant", "mujoco", "--cpu",
         "--standing", "--steps", "2"], cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "device: cpu" in out.stdout
    assert "[mj-loop] step 1:" in out.stdout
    assert "MuJoCo-plant simulation completed" in out.stdout
