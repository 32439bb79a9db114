"""Shared builders for the PyTorch port's parity tests, plus the port's
import hygiene.

Both packages are built from one source: the JAX objects' arrays go through
numpy into `mpc_ilqr_tpu_torch.interop`, so every comparison feeds the two
sides identical inputs. The port runs on the CPU here (its kernel wrappers
take their plain versions); JAX stays on the CPU as the suite's conftest sets.
"""
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ilqr_tpu_torch import interop
from mpc_ilqr_tpu_torch.costs.params import WEIGHT_FIELDS
from mpc_ilqr_tpu_torch.costs.references import TRACK_FIELDS
from mpc_ilqr_tpu_torch.models.robot import ARRAY_FIELDS, STATIC_FIELDS

# One intra-op thread for the port's CPU ops in every test process: the suite
# runs six xdist workers on eight cores, and the port's many small ops gain
# nothing from a thread pool per worker, while eight threads per worker
# oversubscribe the cores the reference's compiles need (CHANGES.md has the
# timings). Every worker imports this module when it collects the test files.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "mpc_ilqr_tpu_torch")
FORBIDDEN = ("jax", "flax", "yaml", "mujoco", "mpc_ilqr_tpu")
TDTYPE = {jnp.float32: torch.float32, jnp.float64: torch.float64}

# The flagship model settings of config.yaml's engine section.
H1_KW = dict(gravity=(0.0, 0.0, -1.0), timestep=0.02, contact_stiffness=5000.0,
             contact_damping=300.0, contact_impratio=100.0)


def model_dict(jm) -> dict:
    d = {f: getattr(jm, f) for f in STATIC_FIELDS}
    d.update({f: np.asarray(getattr(jm, f)) for f in ARRAY_FIELDS})
    return d


def port_model(jm, dtype=torch.float64):
    return interop.model_from_numpy(model_dict(jm), device="cpu", dtype=dtype)


def port_cost_params(cp, dtype=torch.float64):
    d = {f: np.asarray(getattr(cp, f)) for f in WEIGHT_FIELDS}
    d["quat_tangent"] = cp.quat_tangent
    return interop.cost_params_from_numpy(d, device="cpu", dtype=dtype)


def port_refs(refs, dtype=torch.float64):
    return interop.refs_from_numpy({f: np.asarray(getattr(refs, f)) for f in TRACK_FIELDS},
                                   device="cpu", dtype=dtype)


def standing_problem(dtype=jnp.float64):
    """(jax model, jax cost params, jax refs) of the standing flagship."""
    from mpc_ilqr_tpu.costs.params import build_cost_params
    from mpc_ilqr_tpu.io.config import load_config
    from mpc_ilqr_tpu.io.references import load_reference_set
    from mpc_ilqr_tpu.models.robot import load_h1

    app = load_config(os.path.join(ROOT, "config.yaml"))
    jm = load_h1(dtype=dtype, **H1_KW)
    cp = build_cost_params(jm, app.mpc.cost_weights, app.mpc.constraints, dtype=dtype)
    refs = load_reference_set(jm, *(os.path.join(ROOT, "data", f) for f in (
        "q_standing.csv", "v_standing.csv", "contact_standing.csv")), dtype=dtype)
    return jm, cp, refs


def random_state(jm, seed, z=0.98):
    """A perturbed standing state with the feet pressed into the ground."""
    rng = np.random.default_rng(seed)
    x = np.zeros(jm.nx)
    x[2], x[3] = z, 1.0
    x[3:7] += rng.normal(0, 0.05, 4)
    x[7 : jm.nq] += rng.normal(0, 0.2, jm.nq - 7)
    x[jm.nq :] += rng.normal(0, 0.3, jm.nv)
    return x, rng.normal(0, 3.0, jm.nu)


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


# The MuJoCo plant imports mujoco inside a function (import_mujoco), when a
# plant is built; a module-level import there would still load it.
MUJOCO_PLANT = os.path.join(PORT, "mpc", "mujoco_plant.py")
LAZY = {"mujoco": (MUJOCO_PLANT,)}


@pytest.mark.parametrize("module", FORBIDDEN)
def test_port_sources_import_no_reference_stack(module):
    """No import of jax/flax/yaml/mujoco/mpc_ilqr_tpu anywhere in the port
    or in chip_smoke.py (a GPU host need not have any of them), except a
    function-level import of mujoco in mpc/mujoco_plant.py."""
    anywhere = re.compile(rf"^\s*(import|from)\s+{re.escape(module)}(\.|\s|$)", re.M)
    top = re.compile(rf"^(import|from)\s+{re.escape(module)}(\.|\s|$)", re.M)
    hits = [p for p in _port_sources()
            if (top if p in LAZY.get(module, ()) else anywhere).search(open(p).read())]
    assert not hits, f"{module} imported by {hits}"


def test_the_mujoco_plant_module_does_not_import_mujoco():
    """Where mujoco is installed (here), importing the plant and the CLI
    leaves it out of sys.modules; building a plant loads it."""
    pytest.importorskip("mujoco")
    code = ("import sys\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "import mpc_ilqr_tpu_torch.mpc.mujoco_plant as mp, mpc_ilqr_tpu_torch.run_mpc\n"
            "assert 'mujoco' not in sys.modules\n"
            "mp.import_mujoco()\n"
            "assert 'mujoco' in sys.modules\n"
            "print('LAZY_OK')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and "LAZY_OK" in out.stdout, out.stdout + out.stderr


POISONED_RUN = r"""
import sys
class _Poison:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {FORBIDDEN!r}:
            raise ImportError(f"poisoned import of {{name}}")
sys.meta_path.insert(0, _Poison())
for m in list(sys.modules):
    if m.split(".")[0] in {FORBIDDEN!r}:
        del sys.modules[m]
sys.path.insert(0, {ROOT!r})
import chip_smoke
import mpc_ilqr_tpu_torch, mpc_ilqr_tpu_torch.interop, mpc_ilqr_tpu_torch.ops.step_plan
import mpc_ilqr_tpu_torch.ops.rollout_kernel, mpc_ilqr_tpu_torch.ops._build
import mpc_ilqr_tpu_torch.ops.riccati, mpc_ilqr_tpu_torch.scenarios
import mpc_ilqr_tpu_torch.ops.linalg, mpc_ilqr_tpu_torch.parallel.fleet
import mpc_ilqr_tpu_torch.io.native, mpc_ilqr_tpu_torch.io.logging
import mpc_ilqr_tpu_torch.utils.profiling, mpc_ilqr_tpu_torch.mpc.checkpoint
import mpc_ilqr_tpu_torch.run_mpc, mpc_ilqr_tpu_torch.mpc.mujoco_plant
import mpc_ilqr_tpu_torch.ops.assoc_riccati, mpc_ilqr_tpu_torch.ops.quat_fk
import mpc_ilqr_tpu_torch.parallel.sharded_solve, mpc_ilqr_tpu_torch.parallel.sharding
import contextlib, io
err = io.StringIO()
with contextlib.redirect_stderr(err):
    try:
        mpc_ilqr_tpu_torch.run_mpc.main(["--plant", "mujoco", "--cpu", "--steps", "1"])
        raise AssertionError("--plant mujoco ran without mujoco")
    except SystemExit as e:
        assert e.code == 2, e.code
assert "needs the mujoco package" in err.getvalue(), err.getvalue()
from mpc_ilqr_tpu_torch.io.config import load_config
from mpc_ilqr_tpu_torch.mpc import runner, controller
from mpc_ilqr_tpu_torch.models.robot import standing_state
app = load_config({config!r})
app.q_ref_path, app.v_ref_path, app.contact_schedule_path = (
    "data/q_standing.csv", "data/v_standing.csv", "data/contact_standing.csv")
prob = runner.setup(app, device="cpu")
x = standing_state(prob.model)
state, u, diag = controller.step_once(prob.model, prob.cp, prob.cfg, prob.refs,
                                      controller.init_state(prob.model, prob.cfg), x,
                                      plan=prob.plan)
assert diag.solve_ok and bool(u.isfinite().all()), diag
import dataclasses
from mpc_ilqr_tpu_torch import scenarios
lh, _ = scenarios.long_horizon(tuned=True, device="cpu")
lh = lh._replace(cfg=dataclasses.replace(lh.cfg, N=6))
assert lh.cfg.backward == "pallas" and lh.cfg.n_substeps == 1
state, u, diag_lh = controller.step_once(lh.model, lh.cp, lh.cfg, lh.refs,
                                         controller.init_state(lh.model, lh.cfg),
                                         standing_state(lh.model), plan=lh.plan)
assert diag_lh.solve_ok and bool(u.isfinite().all()), diag_lh
ex = scenarios.exact_standing(device="cpu", N=3)
assert (ex.cfg.linearization, ex.cfg.quad_mode) == ("ad", "exact") and ex.plan is not None
state, u, diag_ex = controller.step_once(ex.model, ex.cp, ex.cfg, ex.refs,
                                         controller.init_state(ex.model, ex.cfg),
                                         standing_state(ex.model), plan=ex.plan)
assert diag_ex.solve_ok and bool(u.isfinite().all()), diag_ex
assert not any(m.split(".")[0] in {FORBIDDEN!r} for m in sys.modules), "reference stack leaked"
print("POISONED_OK", prob.cfg.N, diag.iterations, float(diag.cost), lh.cfg.N)
"""


def test_port_runs_with_reference_stack_poisoned():
    """Rehearse the card's run without the card: with jax, flax, yaml,
    mujoco and mpc_ilqr_tpu unimportable, import chip_smoke and the port
    with its runtime modules (native I/O, logging, profiling, checkpoints,
    the CLI, the MuJoCo plant, the associative Riccati pass, the quaternion
    FK, the sharded solve and the mesh), check that `--plant mujoco` fails
    with an error that names mujoco, then set up the flagship from config.yaml and take one MPC
    step on CPU, one long-horizon step with backward="pallas" (K4's
    plain version) at N=6, and one step of scenarios.exact_standing ("ad"
    + "exact") at N=3."""
    code = POISONED_RUN.format(FORBIDDEN=set(FORBIDDEN), ROOT=ROOT,
                               config=os.path.join(ROOT, "config.yaml"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "POISONED_OK 25" in out.stdout
