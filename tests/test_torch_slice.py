"""The slice as a whole: three MPC steps of the port's run_closed_loop
against the JAX package's, float32, in test_mpc.py's small setting (H1,
N=6, max_iterations=3) with the shipped solver numerics
(structured_frozen_mass + gn + cascade); plus the set-up and kernel gate."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ilqr_tpu_torch.io.config import load_config
from mpc_ilqr_tpu_torch.mpc import controller as tctl
from mpc_ilqr_tpu_torch.mpc import runner
from mpc_ilqr_tpu_torch.ops.step_plan import build_step_plan
from test_torch_common import ROOT, port_cost_params, port_model, port_refs

SOLVER = dict(N=6, max_iterations=3, linearization="structured_frozen_mass", quad_mode="gn",
              line_search="cascade")


def _standing_app():
    app = load_config(os.path.join(ROOT, "config.yaml"))
    app.q_ref_path = "data/q_standing.csv"
    app.v_ref_path = "data/v_standing.csv"
    app.contact_schedule_path = "data/contact_standing.csv"
    return app


def test_closed_loop_matches_reference():
    """Equal iterations and solve_ok at every step; x, u and cost agree to
    float32 round-off carried through three solves. Tolerances: x 1e-5,
    u 5e-4 (|u| ~ 0.7), cost rtol 1e-4 — the two float32 implementations
    factor lhs matrices of condition ~1e4 in different operation orders, so
    they part at ~1e-7 in x and ~3e-5 in u (measured); the bars leave 10x."""
    from mpc_ilqr_tpu.costs.params import build_cost_params
    from mpc_ilqr_tpu.ilqr.solver import ILQRConfig
    from mpc_ilqr_tpu.io.config import load_config as j_load_config
    from mpc_ilqr_tpu.io.references import load_reference_set
    from mpc_ilqr_tpu.models.robot import load_h1
    from mpc_ilqr_tpu.models.robot import standing_state as j_standing_state
    from mpc_ilqr_tpu.mpc import controller as jctl

    app = j_load_config(os.path.join(ROOT, "config.yaml"))
    jm = load_h1(gravity=tuple(app.mpc.gravity), timestep=0.02, dtype=jnp.float32)
    cp = build_cost_params(jm, app.mpc.cost_weights, app.mpc.constraints, dtype=jnp.float32)
    refs = load_reference_set(jm, *(os.path.join(ROOT, "data", f) for f in (
        "q_standing.csv", "v_standing.csv", "contact_standing.csv")), dtype=jnp.float32)
    cfg = ILQRConfig(**SOLVER)
    x0 = j_standing_state(jm)
    run = jax.jit(functools.partial(jctl.run_closed_loop, jm, cp, cfg, n_steps=3))
    _, jxT, jh = run(refs, jctl.init_state(jm, cfg), x0)

    from mpc_ilqr_tpu_torch.ilqr.solver import ILQRConfig as TConfig

    tm = port_model(jm, torch.float32)
    tcfg = TConfig(**SOLVER, rollout_backend="pallas", ls_backend="pallas_batched")
    plan = build_step_plan(tm)
    _, txT, th = tctl.run_closed_loop(tm, port_cost_params(cp, torch.float32), tcfg,
                                      port_refs(refs, torch.float32),
                                      tctl.init_state(tm, tcfg),
                                      torch.tensor(np.asarray(x0)), 3, plan=plan)
    assert th["iterations"] == np.asarray(jh["iterations"]).tolist()
    assert th["solve_ok"] == np.asarray(jh["solve_ok"]).tolist() == [True] * 3
    np.testing.assert_allclose(th["x"].numpy(), np.asarray(jh["x"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(txT.numpy(), np.asarray(jxT), rtol=0, atol=1e-5)
    np.testing.assert_allclose(th["u"].numpy(), np.asarray(jh["u"]), rtol=0, atol=5e-4)
    np.testing.assert_allclose(th["cost"].numpy(), np.asarray(jh["cost"]), rtol=1e-4)
    costs = th["cost"].numpy()
    assert costs[-1] < costs[0]


def test_tvlqr_control_and_reset_match_reference():
    """The inter-solve TV-LQR law and MPC::reset on a random carry."""
    from mpc_ilqr_tpu.ilqr.solver import ILQRConfig
    from mpc_ilqr_tpu.mpc import controller as jctl
    from mpc_ilqr_tpu_torch.ilqr.solver import ILQRConfig as TConfig

    rng = np.random.default_rng(2)
    N, nx, nu = 4, 51, 19
    xbar, ubar = rng.normal(size=(N + 1, nx)), rng.normal(size=(N, nu))
    K, x = rng.normal(size=(N, nu, nx)), rng.normal(size=nx)
    for has_prev in (True, False):
        js = jctl.MPCState(t_idx=jnp.asarray(3), prev_xbar=jnp.asarray(xbar),
                           prev_ubar=jnp.asarray(ubar), prev_K=jnp.asarray(K),
                           has_prev=jnp.asarray(has_prev), reg=jnp.asarray(1e-4))
        ts = tctl.MPCState(t_idx=3, prev_xbar=torch.tensor(xbar), prev_ubar=torch.tensor(ubar),
                           prev_K=torch.tensor(K), has_prev=has_prev,
                           reg=torch.tensor(1e-4, dtype=torch.float64))
        np.testing.assert_allclose(tctl.tvlqr_control(ts, torch.tensor(x)).numpy(),
                                   np.asarray(jctl.tvlqr_control(js, jnp.asarray(x))),
                                   rtol=0, atol=1e-12)
        jr, tr = jctl.reset(js, ILQRConfig(N=N)), tctl.reset(ts, TConfig(N=N))
        assert tr.t_idx == int(jr.t_idx) and tr.has_prev == bool(jr.has_prev)
        assert float(tr.reg) == float(jr.reg) and not tr.prev_K.any()


def test_setup_builds_the_flagship_on_the_asked_device():
    prob = runner.setup(_standing_app(), device="cpu")
    m, cfg = prob.model, prob.cfg
    assert m.device.type == "cpu" and m.dtype == torch.float32
    assert (cfg.N, cfg.max_iterations, cfg.tolerance) == (25, 4, 1e-3)
    assert (cfg.linearization, cfg.quad_mode, cfg.line_search) == (
        "structured_frozen_mass", "gn", "cascade")
    assert (cfg.rollout_backend, cfg.ls_backend, cfg.n_substeps) == ("pallas", "pallas_batched", 1)
    assert prob.plan is not None and prob.refs.x.shape == (200, 51)
    assert float(m.contact_stiffness) == 5000.0 and float(m.contact_impratio) == 100.0


def test_setup_defaults_to_the_card():
    """No silent CPU fallback: without a device argument the problem goes to
    CUDA, and where there is no card that raises."""
    if torch.cuda.is_available():
        assert runner.setup(_standing_app()).model.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            runner.setup(_standing_app())


BALL_XML = """<mujoco><option timestep="0.02"/><worldbody>
  <body name="a" pos="0 0 1"><inertial pos="0 0 -0.2" mass="1" diaginertia="0.1 0.1 0.1"/>
    <joint name="j" type="ball"/>
    <body name="b" pos="0 0 -0.4"><inertial pos="0 0 -0.2" mass="1" diaginertia="0.1 0.1 0.1"/>
      <joint name="k" axis="0 1 0"/></body></body></worldbody>
  <actuator><motor joint="k"/></actuator></mujoco>"""


def test_kernel_gate_on_cpu_drops_to_the_plain_loops_with_a_notice(tmp_path, capsys):
    from mpc_ilqr_tpu_torch.ilqr.solver import ILQRConfig
    from mpc_ilqr_tpu_torch.models.robot import load_robot

    p = tmp_path / "ball.xml"
    p.write_text(BALL_XML)
    m = load_robot(str(p), device="cpu")
    cfg = ILQRConfig(rollout_backend="pallas", ls_backend="pallas_batched", line_search="cascade")
    plan, cfg2 = runner.build_plan_gated(m, cfg, torch.float32)
    assert plan is None
    assert (cfg2.rollout_backend, cfg2.ls_backend, cfg2.cascade_p1_backend) == ("xla",) * 3
    assert "rollout kernels unavailable" in capsys.readouterr().err
    plan, cfg3 = runner.build_plan_gated(m, dataclasses.replace(
        cfg, rollout_backend="xla", ls_backend="xla", cascade_p1_backend="xla"), torch.float32)
    assert plan is None and cfg3.rollout_backend == "xla"
