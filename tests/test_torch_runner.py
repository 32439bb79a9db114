"""The system's entry point in the port against the JAX package's:
`runner.run_simulation` on the walking config (config.yaml unswapped, N=6,
max_iterations=3, 3 sim steps, float32, CPU) with both packages' loggers;
checkpoints written by either package and read by the other; and a
diverged state, which both packages step to NaN.

The run's iterations and solve_ok must be equal. Its tolerances are
tests/test_torch_slice.py's scaled to walking: x 6e-4, u 2.5e-2, cost
rtol 1e-4. Walking's first solves start from cost ~7.7e3 with |u| up to
~15 (standing: ~1 and ~0.7), and float32 round-off grows with them:
tools/port_walking_parity.py measured the two packages' float32 runs apart
by up to 6.4e-5 in x, 2.4e-3 in u and 6.4e-7 in the cost (relative), and
their float64 runs, same code otherwise, by 5.5e-14, 1.7e-12 and 3.6e-16 —
so the float32 gap is round-off, and the bars sit ~10x above it, as the
slice test's do. The logs' headers must be byte-identical; their numeric
columns (all but solve_time_ms) are held at the same tolerances, the
reference rows (x_ref, u_ref) exactly. The JAX package's walking run and its
logs are tests/torch_fixtures/walking_h1.npz (tools/port_parity_fixture.py).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import recording_waits
from mpc_ilqr_tpu_torch.io import logging as tiolog
from mpc_ilqr_tpu_torch.io.config import load_config
from mpc_ilqr_tpu_torch.models.robot import standing_state
from mpc_ilqr_tpu_torch.mpc import checkpoint as tckpt
from mpc_ilqr_tpu_torch.mpc import controller as tctl
from mpc_ilqr_tpu_torch.mpc import runner as trunner
from test_torch_common import ROOT

SMALL = dict(N=6, max_iterations=3)
STEPS = 3
X_ATOL, U_ATOL, COST_RTOL = 6e-4, 2.5e-2, 1e-4


def _logs(root):
    """(step log, q_optimal, u_optimal) as (header line, float64 rows)."""
    out = []
    for p in ("logs/mpc_log.csv", "results/q_optimal.csv", "results/u_optimal.csv"):
        with open(os.path.join(root, p)) as f:
            header = f.readline().rstrip("\n")
        out.append((header, np.atleast_2d(np.loadtxt(os.path.join(root, p), delimiter=",",
                                                     skiprows=1))))
    return out


WALKING_FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "walking_h1.npz")


@pytest.fixture(scope="module")
def walking_runs(tmp_path_factory):
    """Both packages' run_simulation on the walking config: the port's here,
    writing its logs under its own directory; the JAX package's from
    tests/torch_fixtures/walking_h1.npz (tools/port_parity_fixture.py: the
    same set-up with the package's own loggers, compiled once), with its
    logs' headers and rows."""
    fx = np.load(WALKING_FIXTURE)
    runs = {"jax": dict(
        hist={k: list(fx[k]) if k in ("x", "u") else fx[k].tolist()
              for k in map(str, fx["hist_keys"])},
        t_idx=int(fx["t_idx"]), solve_ok=fx["solve_ok"].tolist(),
        logs=[(str(fx[f"{k}_header"]), fx[f"{k}_rows"]) for k in ("log", "q", "u")])}
    tprob = trunner.setup(load_config(os.path.join(ROOT, "config.yaml")), device="cpu")
    tprob = tprob._replace(cfg=dataclasses.replace(tprob.cfg, **SMALL))
    assert tprob.refs.length == int(fx["refs_length"]) == 400  # the walking references
    d = str(tmp_path_factory.mktemp("port"))
    m = tprob.model
    oks = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trunner, "block_until_ready", recording_waits(trunner, oks))
        hist, state = trunner.run_simulation(
            tprob, sim_steps=STEPS, verbose=False,
            step_logger=tiolog.StepLogger(os.path.join(d, "logs", "mpc_log.csv"), m.nx, m.nu),
            traj_logger=tiolog.OptimalTrajectoryLogger(os.path.join(d, "results"), m.nq, m.nu))
    runs["port"] = dict(hist=hist, t_idx=state.t_idx, solve_ok=oks, logs=_logs(d))
    return runs


def test_run_simulation_matches_reference_on_walking(walking_runs):
    j, t = walking_runs["jax"], walking_runs["port"]
    jh, th = j["hist"], t["hist"]
    assert sorted(th) == sorted(jh) == ["cost", "iterations", "solve_ms", "u", "x"]
    assert len(th["cost"]) == len(jh["cost"]) == STEPS
    assert th["iterations"] == jh["iterations"]
    assert t["solve_ok"] == j["solve_ok"] and len(t["solve_ok"]) == STEPS
    # A gravity-compensation fallback happens exactly where solve_ok is false.
    assert t["solve_ok"].count(False) == j["solve_ok"].count(False)
    np.testing.assert_allclose(np.stack(th["x"]), np.stack(jh["x"]), rtol=0, atol=X_ATOL)
    np.testing.assert_allclose(np.stack(th["u"]), np.stack(jh["u"]), rtol=0, atol=U_ATOL)
    np.testing.assert_allclose(th["cost"], jh["cost"], rtol=COST_RTOL)
    assert th["x"][0].dtype == jh["x"][0].dtype == np.float32
    assert t["t_idx"] == j["t_idx"]


def test_run_simulation_logs_match_reference(walking_runs):
    (jh, js), (jqh, jq), (juh, ju) = walking_runs["jax"]["logs"]
    (th, ts), (tqh, tq), (tuh, tu) = walking_runs["port"]["logs"]
    assert (th, tqh, tuh) == (jh, jqh, juh)
    assert ts.shape == js.shape == (STEPS, 4 + 2 * (51 + 19))
    cols = jh.split(",")
    col = lambda prefix: [i for i, c in enumerate(cols) if c.startswith(prefix)]
    np.testing.assert_array_equal(ts[:, :2], js[:, :2])  # time_index, time_sec
    np.testing.assert_allclose(ts[:, 2], js[:, 2], rtol=COST_RTOL)
    np.testing.assert_allclose(ts[:, col("x_")], js[:, col("x_")], rtol=0, atol=X_ATOL)
    np.testing.assert_allclose(ts[:, col("u_")], js[:, col("u_")], rtol=0, atol=U_ATOL)
    ref_cols = col("x_ref_") + col("u_ref_")
    np.testing.assert_array_equal(ts[:, ref_cols], js[:, ref_cols])
    assert tq.shape == jq.shape and tu.shape == ju.shape
    np.testing.assert_array_equal(tq[:, :2], jq[:, :2])
    np.testing.assert_allclose(tq[:, 2:], jq[:, 2:], rtol=0, atol=X_ATOL)
    np.testing.assert_allclose(tu[:, 2:], ju[:, 2:], rtol=0, atol=U_ATOL)


# ---- checkpoints ---------------------------------------------------------------

def _random_carry(seed, N=5, nx=51, nu=19):
    rng = np.random.default_rng(seed)
    return dict(t_idx=7, prev_xbar=rng.normal(size=(N + 1, nx)).astype(np.float32),
                prev_ubar=rng.normal(size=(N, nu)).astype(np.float32),
                prev_K=rng.normal(size=(N, nu, nx)).astype(np.float32), has_prev=True,
                reg=np.float32(3e-5))


def _assert_same_carry(port_state, want: dict):
    assert type(port_state.t_idx) is int and port_state.t_idx == want["t_idx"]
    assert type(port_state.has_prev) is bool and port_state.has_prev == want["has_prev"]
    for k in ("prev_xbar", "prev_ubar", "prev_K", "reg"):
        got = getattr(port_state, k)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[k]))


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    from mpc_ilqr_tpu.mpc import checkpoint as jckpt
    from mpc_ilqr_tpu.mpc.controller import MPCState as JState

    c = _random_carry(0)
    js = JState(t_idx=jnp.asarray(c["t_idx"], jnp.int32), has_prev=jnp.asarray(c["has_prev"]),
                **{k: jnp.asarray(c[k]) for k in ("prev_xbar", "prev_ubar", "prev_K", "reg")})
    p = str(tmp_path / "ref_state.npz")
    jckpt.save_state(p, js)
    _assert_same_carry(tckpt.load_state(p, device="cpu"), c)


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    from mpc_ilqr_tpu.mpc import checkpoint as jckpt

    c = _random_carry(1)
    ts = tctl.MPCState(t_idx=c["t_idx"], has_prev=c["has_prev"],
                       **{k: torch.as_tensor(c[k]) for k in ("prev_xbar", "prev_ubar", "prev_K",
                                                              "reg")})
    p = str(tmp_path / "port_state.npz")
    tckpt.save_state(p, ts)
    with np.load(p) as z:  # the reference's own field names and dtypes
        assert sorted(z.files) == sorted(["t_idx", "prev_xbar", "prev_ubar", "prev_K",
                                          "has_prev", "reg"])
        assert z["t_idx"].dtype == np.int32 and z["has_prev"].dtype == np.bool_
        assert z["t_idx"].shape == z["has_prev"].shape == z["reg"].shape == ()
    js = jckpt.load_state(p)
    assert int(js.t_idx) == c["t_idx"] and bool(js.has_prev) is True
    for k in ("prev_xbar", "prev_ubar", "prev_K", "reg"):
        np.testing.assert_array_equal(np.asarray(getattr(js, k)), np.asarray(c[k]))
    # And back: the reference's re-save of the port's file reads as the original.
    p2 = str(tmp_path / "again.npz")
    jckpt.save_state(p2, js)
    _assert_same_carry(tckpt.load_state(p2, device="cpu"), c)


def test_set_time_index_and_load_default_device(tmp_path):
    c = _random_carry(2)
    ts = tctl.MPCState(t_idx=c["t_idx"], has_prev=c["has_prev"],
                       **{k: torch.as_tensor(c[k]) for k in ("prev_xbar", "prev_ubar", "prev_K",
                                                              "reg")})
    moved = tckpt.set_time_index(ts, 42)
    assert moved.t_idx == 42 and ts.t_idx == 7 and moved.prev_K is ts.prev_K
    p = str(tmp_path / "s.npz")
    tckpt.save_state(p, ts)
    if torch.cuda.is_available():
        assert tckpt.load_state(p).prev_K.device.type == "cuda"
    else:  # no silent CPU fallback: the default device is the card
        with pytest.raises((RuntimeError, AssertionError)):
            tckpt.load_state(p)


def test_continuing_from_a_restored_state_gives_the_same_step(tmp_path):
    """tests/test_mpc.py:112-128 in the port, through a file: the next
    step_once from the restored state equals the one from the original."""
    app = load_config(os.path.join(ROOT, "config.yaml"))
    app.q_ref_path = "data/q_standing.csv"
    app.v_ref_path = "data/v_standing.csv"
    app.contact_schedule_path = "data/contact_standing.csv"
    prob = trunner.setup(app, device="cpu")
    prob = prob._replace(cfg=dataclasses.replace(prob.cfg, **SMALL))
    m, step = prob.model, lambda s, x: tctl.step_once(m, prob.cp, prob.cfg, prob.refs, s, x,
                                                      plan=prob.plan)
    x = standing_state(m)
    state, _, _ = step(tctl.init_state(m, prob.cfg), x)
    p = str(tmp_path / "carry.npz")
    tckpt.save_state(p, state)
    restored = tckpt.load_state(p, dtype=m.dtype, device="cpu")
    s1, u1, d1 = step(state, x)
    s2, u2, d2 = step(restored, x)
    np.testing.assert_array_equal(u1.numpy(), u2.numpy())
    np.testing.assert_array_equal(s1.prev_ubar.numpy(), s2.prev_ubar.numpy())
    assert (s1.t_idx, d1.iterations, float(d1.cost)) == (s2.t_idx, d2.iterations, float(d2.cost))


def test_run_simulation_steps_the_plant_model_it_is_given():
    """`sim_model` (here 1.25x the mass) is the plant: its plain step moves
    the state, while the controller keeps its own model and kernel plan."""
    from mpc_ilqr_tpu_torch.dynamics import engine as tengine
    from mpc_ilqr_tpu_torch.models.robot import scale_robot_mass

    app = load_config(os.path.join(ROOT, "config.yaml"))
    app.q_ref_path = "data/q_standing.csv"
    app.v_ref_path = "data/v_standing.csv"
    app.contact_schedule_path = "data/contact_standing.csv"
    prob = trunner.setup(app, device="cpu")
    prob = prob._replace(cfg=dataclasses.replace(prob.cfg, **SMALL))
    heavy = scale_robot_mass(prob.model, 1.25)
    hist, _ = trunner.run_simulation(prob, sim_steps=2, verbose=False, sim_model=heavy)
    x0, u0 = torch.from_numpy(hist["x"][0]), torch.from_numpy(hist["u"][0])
    np.testing.assert_array_equal(hist["x"][1], tengine.step(heavy, x0, u0).numpy())
    assert not np.array_equal(hist["x"][1], tengine.step(prob.model, x0, u0).numpy())


# ---- a diverged state ----------------------------------------------------------

PENDULUM_XML = """<mujoco><option timestep="0.02"/><worldbody>
  <body name="a" pos="0 0 1"><inertial pos="0 0 -0.3" mass="1" diaginertia="0.1 0.1 0.1"/>
    <joint name="j" axis="0 1 0" damping="0.1"/></body></worldbody>
  <actuator><motor joint="j"/></actuator></mujoco>"""


def test_a_diverged_state_steps_to_nan_as_in_the_reference(tmp_path):
    """A line-search candidate that diverges reaches a state whose implicit
    lhs cannot be factored. The reference's Cholesky (jax.scipy cho_factor)
    then returns NaN, the candidate's cost is NaN and the line search
    rejects it; the port's step and step_and_jac must do the same, not
    raise (the walking run on the CPU stopped at step 50 on the raise).
    A finite state steps as the reference does (float64, 1e-12)."""
    from mpc_ilqr_tpu.dynamics import engine as jengine
    from mpc_ilqr_tpu.models.robot import load_robot as j_load_robot
    from mpc_ilqr_tpu_torch.dynamics import engine as tengine
    from test_torch_common import port_model

    p = tmp_path / "pendulum.xml"
    p.write_text(PENDULUM_XML)
    jm = j_load_robot(str(p), dtype=jnp.float64)
    tm = port_model(jm, torch.float64)
    u = np.array([0.3])
    for x in (np.array([np.nan, 0.0]), np.array([0.4, -1.2])):
        want = np.asarray(jax.jit(lambda xx, uu: jengine.step(jm, xx, uu))(x, u))
        got = tengine.step(tm, torch.tensor(x), torch.tensor(u))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
        x_next, A, B = tengine.step_and_jac(tm, torch.tensor(x), torch.tensor(u))
        np.testing.assert_allclose(x_next.numpy(), want, rtol=0, atol=1e-12)
        assert bool(torch.isnan(A).any()) == bool(np.isnan(x).any())
