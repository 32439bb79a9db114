"""The port's host runtime against the JAX package's: the native CSV reader
and telemetry writer, the CSV logs, the profiler's table, the model
helpers (`scale_robot_mass`, `set_gravity`, `contact_forces`) and the
`python -m mpc_ilqr_tpu_torch.run_mpc` command line.

Tolerances: the reader, the logs and the profiler's layout must be equal
(bit for bit, byte for byte, line for line with timings masked); the
helpers are compared in float64 at 1e-10 (the same arithmetic in two
frameworks: round-off only).
"""
import glob
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ilqr_tpu_torch.dynamics import engine as tengine
from mpc_ilqr_tpu_torch.io import logging as tiolog
from mpc_ilqr_tpu_torch.io import native as tnative
from mpc_ilqr_tpu_torch.models import robot as trobot
from mpc_ilqr_tpu_torch.utils import profiling as tprof
from test_torch_common import H1_KW, ROOT, port_model, random_state

DATA = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "data", "*.csv")))


# ---- the native library ----------------------------------------------------------

def test_native_library_builds_under_build_not_native():
    assert tnative.available(), tnative.build_error
    path = tnative.build()
    assert path.startswith(os.path.join(ROOT, "build", "native") + os.sep)
    assert os.path.isfile(path) and path.endswith("libmpcio.so")
    assert tnative.build() == path  # cached by hash: no second build


@pytest.fixture(scope="module")
def jnative(tmp_path_factory):
    """The JAX package's native reader, its library built by the package's
    own loader into a private path. The loader builds native/libmpcio.so
    in place, so a test worker that loads it while another worker's g++ is
    still writing it gets no library, falls back to np.loadtxt for the rest
    of the process, and that cannot read the contact files' header row."""
    from mpc_ilqr_tpu.io import native as jn

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jn, "_LIB_PATH", str(tmp_path_factory.mktemp("jnative") / "libmpcio.so"))
        mp.setattr(jn, "_lib", None)
        mp.setattr(jn, "_tried", False)
        assert jn.available()
        yield jn


@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("name", DATA)
def test_read_csv_matrix_matches_reference_bit_for_bit(name, skip, jnative):
    path = os.path.join(ROOT, "data", name)
    got, want = tnative.read_csv_matrix(path, skip), jnative.read_csv_matrix(path, skip)
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))
    if skip == 1 or not name.startswith("contact"):  # the contact files have a header
        ref = np.atleast_2d(np.loadtxt(path, delimiter=",", skiprows=skip, dtype=np.float64))
        np.testing.assert_array_equal(got.view(np.uint64), ref.view(np.uint64))


def test_reference_tracks_read_as_numpy_reads_them():
    """io/references.py reads through the native parser now: the walking
    and standing tracks come out as np.loadtxt gives them."""
    from mpc_ilqr_tpu_torch.io import references as tref

    for name in ("q_ref2_mj.csv", "v_ref2.csv", "q_standing.csv"):
        path = os.path.join(ROOT, "data", name)
        np.testing.assert_array_equal(tref.load_csv_matrix(path),
                                      np.loadtxt(path, delimiter=","))
    sched = tref.load_contact_schedule(os.path.join(ROOT, "data", "contact_walking.csv"))
    np.testing.assert_array_equal(sched, np.loadtxt(
        os.path.join(ROOT, "data", "contact_walking.csv"), delimiter=",", skiprows=1))


def test_async_telemetry_round_trips_with_nothing_dropped(tmp_path):
    """5000 rows of the step log's width through the background writer:
    `close` drains the queue and joins the thread, so every row is in the
    file when it returns, printed as %.9g."""
    rng = np.random.default_rng(3)
    rows = rng.normal(0, 100, (5000, 4 + 2 * (51 + 19)))
    path = str(tmp_path / "telemetry.csv")
    t = tnative.AsyncTelemetry(path, "h")
    assert t.native
    for r in rows:
        t.log(r)
    t.close()
    assert t.dropped == 0
    back = tnative.read_csv_matrix(path, skip_rows=1)
    want = np.array([[float(f"{v:.9g}") for v in r] for r in rows])
    np.testing.assert_array_equal(back, want)


# ---- the logs ------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["native", "fallback"])
def test_logs_are_byte_identical_to_the_reference(tmp_path, monkeypatch, writer):
    """The same rows through the port's loggers (as float32 tensors) and
    the reference's (as numpy arrays) give the same bytes, through the
    native writer and through the pure-Python fallback."""
    from mpc_ilqr_tpu.io import logging as jiolog
    from mpc_ilqr_tpu.io import native as jnative

    if writer == "fallback":
        monkeypatch.setattr(jnative, "_load", lambda: None)
        monkeypatch.setattr(tnative, "_load", lambda: None)
    nx, nq, nu = 51, 26, 19
    files = {}
    for side, iolog in (("ref", jiolog), ("port", tiolog)):
        d = tmp_path / side
        step = iolog.StepLogger(str(d / "logs" / "mpc_log.csv"), nx, nu)
        traj = iolog.OptimalTrajectoryLogger(str(d / "results"), nq, nu)
        if side == "port":
            assert step.native == (writer == "native")
        r = np.random.default_rng(4)
        for i in range(6):
            x, u = r.normal(0, 3, nx).astype(np.float32), r.normal(0, 10, nu).astype(np.float32)
            x_ref, u_ref = r.normal(0, 1, nx).astype(np.float32), np.zeros(nu, np.float32)
            x[i] = -0.0 if i % 2 else 1e-30
            cost, ms = float(np.float32(r.uniform(0, 1e4))), float(r.uniform(0, 1e3))
            q, uo = x[:nq].copy(), u * 0.5
            if side == "port":  # tensors, and the cost as a float32 tensor in every other row
                x, u, x_ref, u_ref, q, uo = map(torch.from_numpy, (x, u, x_ref, u_ref, q, uo))
                cost = torch.tensor(cost, dtype=torch.float32) if i % 2 else cost
            step.log(i + 1, 0.02, cost, ms, x, u, x_ref, u_ref)
            traj.log(i + 1, 0.02, q, uo)
        step.close()
        traj.close()
        files[side] = {p: (d / p).read_bytes() for p in (
            "logs/mpc_log.csv", "results/q_optimal.csv", "results/u_optimal.csv")}
    for p in files["ref"]:
        assert files["port"][p] == files["ref"][p], p
        assert files["ref"][p].count(b"\n") == 7


# ---- the profiler ---------------------------------------------------------------

STAGES = ("MPC_stepOnce", "MPC_extractReference", "MPC_warmStart", "MPC_iLQR_solve",
          "MPC_computeControl", "iLQR_forwardRollout", "iLQR_linearization",
          "iLQR_costQuadratics", "iLQR_backwardPass", "iLQR_lineSearch", "iLQR_computeCost")


def test_profiler_report_matches_the_reference_line_for_line():
    from mpc_ilqr_tpu.utils import profiling as jprof

    for mod in (jprof, tprof):  # the stage names both modules document
        names = re.findall(r"\b(?:MPC|iLQR)_\w+", mod.__doc__)
        assert tuple(names) == STAGES
    reports = []
    for mod, arr in ((jprof, jnp.ones), (tprof, torch.ones)):
        p = mod.Profiler(enabled=True)
        for i, name in enumerate(STAGES):
            for k in range(1 + i % 3):
                p.record(name, 0.5 * (i + 1) + k)
        with p.stage("stage_block", block_on=arr(3)):
            pass
        assert p.time_fn("time_fn", lambda: arr(4) * 2).shape == (4,)
        reports.append(p.report())
    mask = lambda s: re.sub(r"\s*\d+\.\d{2}", "#", s)  # a number and its padding
    j_lines, t_lines = reports[0].splitlines(), reports[1].splitlines()
    # title (4), table head (2), a row per stage and the two timed ones, memory (6)
    assert len(t_lines) == len(j_lines) == 4 + 2 + len(STAGES) + 2 + 6
    for jl, tl in zip(j_lines, t_lines):
        if jl.split(" ")[0] in STAGES:  # recorded timings: the same numbers
            assert tl == jl
        else:
            assert mask(tl) == mask(jl)


def test_profiler_disabled_and_cpu_outputs_need_no_wait():
    p = tprof.Profiler(enabled=False)
    with p.stage("x", block_on=torch.ones(2)):
        pass
    assert not p.times
    nest = {"a": (torch.ones(1), [torch.zeros(2)]), "b": None}
    assert tprof.block_until_ready(nest) is nest
    assert tprof._cuda_devices(nest, set()) == set()


# ---- the model helpers ----------------------------------------------------------

@pytest.fixture(scope="module")
def h1_f64():
    from mpc_ilqr_tpu.models.robot import load_h1

    jm = load_h1(dtype=jnp.float64, **H1_KW)
    x_pert, _ = random_state(jm, 11)
    jx0 = np.zeros(jm.nx)
    jx0[2], jx0[3] = 1.0432, 1.0
    return jm, port_model(jm, torch.float64), {"standing": jx0, "perturbed": x_pert}


@pytest.mark.parametrize("which", ["standing", "perturbed"])
def test_mass_gravity_and_contact_helpers_match_reference(h1_f64, which):
    from mpc_ilqr_tpu.dynamics import engine as jengine
    from mpc_ilqr_tpu.models import robot as jrobot

    jm, tm, states = h1_f64
    x = states[which]
    tx = torch.tensor(x)
    close = lambda got, want: np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=0, atol=1e-10)
    variants = {
        "scaled": (jrobot.scale_robot_mass(jm, 1.25), trobot.scale_robot_mass(tm, 1.25)),
        "gravity": (jrobot.set_gravity(jm, 0.0, 0.0, -9.81),
                    trobot.set_gravity(tm, 0.0, 0.0, -9.81)),
    }
    for jv, tv in variants.values():
        for f in ("body_mass", "body_inertia", "gravity"):
            close(getattr(tv, f), getattr(jv, f))
        assert getattr(tv, "gravity").dtype == torch.float64
        close(tengine.gravity_comp(tv, tx),
              jax.jit(lambda xx, jv=jv: jengine.gravity_comp(jv, xx))(jnp.asarray(x)))
    f_t, p_t = tengine.contact_forces(tm, tx)
    f_j, p_j = jax.jit(lambda xx: jengine.contact_forces(jm, xx))(jnp.asarray(x))
    close(f_t, f_j)
    close(p_t, p_j)
    assert f_t.shape == (tm.ncp, 3)
    if which == "perturbed":  # feet pressed in: some point pushes back
        assert float(f_t[:, 2].max()) > 0.0
    assert torch.equal(tm.body_mass, port_model(jm, torch.float64).body_mass)  # pure update


def test_heavier_robot_needs_proportionally_more_gravity_compensation():
    """tests/test_checkpoint.py:38-51 on the port (float32)."""
    model = trobot.load_h1(dtype=torch.float32, device="cpu")
    m2 = trobot.scale_robot_mass(model, 1.25)
    np.testing.assert_allclose(m2.body_mass.numpy(), 1.25 * model.body_mass.numpy(), rtol=1e-6)
    m3 = trobot.set_gravity(model, 0.0, 0.0, -9.81)
    np.testing.assert_allclose(m3.gravity.numpy(), [0, 0, -9.81])
    x = trobot.standing_state(model)
    u1 = tengine.gravity_comp(model, x).numpy()
    u2 = tengine.gravity_comp(m2, x).numpy()
    np.testing.assert_allclose(u2, 1.25 * u1, rtol=1e-4)


# ---- the command line ----------------------------------------------------------

def _cli(tmp_path, *args):
    """Run the port's CLI on a copy of config.yaml with horizon 6 whose
    relative paths (robots/, data/, logs/, results/) resolve in tmp_path."""
    text = open(os.path.join(ROOT, "config.yaml")).read()
    lines = [("  horizon: 6" if ln.strip().startswith("horizon:") else ln)
             for ln in text.splitlines()]
    (tmp_path / "config.yaml").write_text("\n".join(lines) + "\n")
    for d in ("robots", "data"):
        if not (tmp_path / d).exists():
            os.symlink(os.path.join(ROOT, d), tmp_path / d)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "mpc_ilqr_tpu_torch.run_mpc", "--config",
                           str(tmp_path / "config.yaml"), *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def test_cli_runs_standing_on_the_cpu_and_writes_reference_logs(tmp_path):
    from mpc_ilqr_tpu.io import logging as jiolog

    out = _cli(tmp_path, "--cpu", "--standing", "--steps", "2", "--quiet", "--profile")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "Configuration loaded from" in out.stdout
    assert "horizon N=6" in out.stdout and "device: cpu" in out.stdout
    for line in ("Simulation completed in", "Average step time:", "Steady-state solve:",
                 "=== Performance Profiling ===", "MPC_stepOnce"):
        assert line in out.stdout
    assert "Step 0/2" not in out.stdout  # --quiet
    ref = tmp_path / "ref"
    lg = jiolog.StepLogger(str(ref / "mpc_log.csv"), 51, 19)
    lg.close()
    tl = jiolog.OptimalTrajectoryLogger(str(ref), 26, 19)
    tl.close()
    for got, want in (("logs/mpc_log.csv", "mpc_log.csv"), ("results/q_optimal.csv", "q_optimal.csv"),
                      ("results/u_optimal.csv", "u_optimal.csv")):
        lines = (tmp_path / got).read_text().splitlines()
        assert len(lines) == 3
        assert lines[0] == (ref / want).read_text().splitlines()[0]


def test_cli_rejects_what_it_does_not_run(tmp_path):
    """A plant it does not have, and (without a card) a run without --cpu.
    `--plant mujoco` runs since the MuJoCo plant is ported
    (tests/test_torch_mujoco_plant.py; without mujoco it fails naming it,
    tests/test_torch_common.py's poisoned run)."""
    out = _cli(tmp_path, "--cpu", "--plant", "bullet")
    assert out.returncode != 0
    assert "invalid choice" in out.stderr and "bullet" in out.stderr and "mujoco" in out.stderr
    if not torch.cuda.is_available():  # without --cpu it runs on the card or not at all
        out = _cli(tmp_path, "--standing", "--steps", "1")
        assert out.returncode != 0 and "no CUDA device" in out.stderr
        assert not (tmp_path / "logs").exists()
