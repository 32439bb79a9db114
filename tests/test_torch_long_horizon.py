"""The long-horizon slice: `scenarios.long_horizon` builds the set-up of
tools/bench_suite.py:275-336; the tuned solver knobs (outer_loop "scan",
linearize_every) solve as the reference's do; and the amortized TV-LQR loop
with K4 runs like the reference's `_tvlqr_amortized_loop`."""
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ilqr_tpu_torch import scenarios
from mpc_ilqr_tpu_torch.mpc import controller as tctl
from mpc_ilqr_tpu_torch.mpc import runner as trunner
from test_torch_common import ROOT, port_cost_params, port_model, port_refs

TUNED = dict(max_iterations=2, inner_attempts=1, linearize_every=2, outer_loop="scan")


@pytest.fixture(scope="module")
def jax_long_horizon():
    """bench_suite.py:283-297's set-up through the reference's runner."""
    from mpc_ilqr_tpu.io.config import load_config
    from mpc_ilqr_tpu.mpc import runner

    app = load_config(os.path.join(ROOT, "config.yaml"))
    app.q_ref_path = "data/q_standing.csv"
    app.v_ref_path = "data/v_standing.csv"
    app.contact_schedule_path = "data/contact_standing.csv"
    app.mpc.dt = 0.01
    app.mpc.physics_dt = 0.01
    app.mpc.horizon = 100
    return runner.setup(app)


@pytest.mark.parametrize("tuned,iters,solve_every,steps", [
    (False, None, 1, 5), (True, None, 1, 5), (True, 1, 2, 6), (True, 1, 3, 9),
])
def test_long_horizon_builds_the_suite_config(jax_long_horizon, tuned, iters, solve_every, steps):
    """Field by field against the reference's runner.setup with
    bench_suite.py's dataclasses.replace calls; the step count is
    bench_suite's at --steps 15 (n = max(4, 15 // 3), then for k > 1
    max(3k, (n // k) k))."""
    jprob = jax_long_horizon
    jcfg = jprob.cfg
    if tuned:
        jcfg = dataclasses.replace(jcfg, **TUNED)
    jcfg = dataclasses.replace(jcfg, backward="pallas")
    if iters is not None:
        jcfg = dataclasses.replace(jcfg, max_iterations=iters)
    prob, n = scenarios.long_horizon(tuned=tuned, iters=iters, solve_every=solve_every,
                                     device="cpu")
    assert n == steps
    for f in ("N", "max_iterations", "tolerance", "n_substeps", "backward", "inner_attempts",
              "linearize_every", "outer_loop", "line_search", "linearization", "quad_mode",
              "rollout_backend", "ls_backend", "cost_mode", "reg_init", "pd_bump", "alphas"):
        assert getattr(prob.cfg, f) == getattr(jcfg, f), f
    assert (prob.cfg.N, prob.cfg.n_substeps) == (100, 1)
    assert prob.model.timestep == pytest.approx(0.01) and float(jprob.model.timestep) == 0.01
    assert prob.plan is not None and prob.model.device.type == "cpu"
    np.testing.assert_array_equal(prob.refs.x.numpy(), np.asarray(jprob.refs.x))


def test_long_horizon_gate_refuses_float64_for_the_card():
    """The kernel gate raises before a float64 model meets K4 on the card;
    on the CPU the plain version runs in any dtype."""
    from mpc_ilqr_tpu_torch.ilqr.solver import ILQRConfig

    cfg = ILQRConfig(backward="pallas")
    cpu_model = types.SimpleNamespace(device=torch.device("cpu"))
    assert trunner.build_plan_gated(cpu_model, cfg, torch.float64) == (None, cfg)
    card_model = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match="float32-only"):
        trunner.build_plan_gated(card_model, cfg, torch.float64)


def test_scan_solve_with_stale_jacobians_matches_reference(tmp_path):
    """outer_loop="scan", linearize_every=2, max_iterations=3: trip 1 reuses
    trip 0's A, B, trip 2 linearizes anew. Float64, N=5, against the
    reference's solve on the same inputs: xbar, ubar, K, cost and the
    iteration count at 1e-9. On test_model_generality.py's cartpole (dt 0.1,
    so that five knots move the cost), because the reference's three
    statically unrolled trips compile in ~40 s for it and ~215 s for H1 on one
    core. linearize_every=1 gives another answer, so the comparison sees the
    stale trip; "while" ignores linearize_every."""
    from mpc_ilqr_tpu.costs.params import CostParams
    from mpc_ilqr_tpu.costs.references import ReferenceSet, extract_window
    from mpc_ilqr_tpu.ilqr import solver as jsol
    from mpc_ilqr_tpu.models.robot import load_robot
    from mpc_ilqr_tpu_torch.costs.references import extract_window as t_extract_window
    from mpc_ilqr_tpu_torch.ilqr import solver as tsol
    from test_model_generality import CARTPOLE_XML

    p = tmp_path / "cartpole.xml"
    p.write_text(CARTPOLE_XML)
    jm = load_robot(str(p), dtype=jnp.float64, timestep=0.1)
    N, nx, nu, f64 = 5, jm.nx, jm.nu, jnp.float64
    z = lambda *s: jnp.zeros(s, f64)
    Q = jnp.asarray([10.0, 10.0, 1.0, 1.0], f64)
    cp = CostParams(Q=Q, R=jnp.full((nu,), 0.01, f64), Qf=10.0 * Q, w_com=z(), w_com_vel=z(),
                    w_ee_pos=z(), w_ee_vel=z(), w_upright=z(), w_balance=z(),
                    w_joint_limits=z(), w_torque_limits=z(), limit_margin=jnp.asarray(0.1, f64),
                    balance_g=jnp.asarray(9.81, f64))
    refs = ReferenceSet(x=z(N + 1, nx), u=z(N + 1, nu), com=z(N + 1, 3), com_vel=z(N + 1, 3),
                        ee_pos=z(N + 1, 0, 3), ee_vel=z(N + 1, 0, 3),
                        stance=jnp.ones((N + 1, 0), f64))
    x0, ubar0 = np.array([0.5, 0.3, 0.0, 0.0]), np.zeros((N, nu))
    common = dict(N=N, max_iterations=3, tolerance=1e-12, linearization="structured_frozen_mass",
                  quad_mode="gn", line_search="cascade", outer_loop="scan", linearize_every=2)
    win = extract_window(refs, jnp.zeros((), jnp.int32), N)
    js = jax.jit(lambda x, u: jsol.solve(jm, cp, jsol.ILQRConfig(**common), x, win, u))(
        jnp.asarray(x0), jnp.asarray(ubar0))

    tm, tcp = port_model(jm), port_cost_params(cp)
    twin = t_extract_window(port_refs(refs), 0, N)
    run = lambda **kw: tsol.solve(tm, tcp, tsol.ILQRConfig(**{**common, **kw}), torch.tensor(x0),
                                  twin, torch.tensor(ubar0))
    ts = run()
    assert ts.iterations == int(js.iterations) == 3 and ts.success == bool(js.success)
    for f in ("xbar", "ubar", "K"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), rtol=0,
                                   atol=1e-9, err_msg=f)
    assert abs(float(ts.cost) - float(js.cost)) <= 1e-9 * max(1.0, abs(float(js.cost)))
    fresh = run(linearize_every=1)
    assert float((fresh.ubar - ts.ubar).abs().max()) > 1e-3
    assert run(outer_loop="while").ubar.equal(fresh.ubar)


def test_amortized_long_horizon_loop_matches_reference(jax_long_horizon):
    """The slice as a whole: the long-horizon settings (dt 0.01, the tuned
    knobs, 1 iteration, backward "pallas": the reference's kernel in
    interpret mode, the port's plain K4) cut to N=6, solving every 2nd of 4
    control steps, float32. Equal solve_ok and t_idx; x 1e-5, u 5e-4, cost
    rtol 1e-4 — the tolerances and reasons of
    test_torch_slice.py::test_closed_loop_matches_reference. The reference's
    `_tvlqr_amortized_loop` run is tests/torch_fixtures/long_horizon_h1.npz
    (tools/port_parity_fixture.py: the same set-up, compiled once)."""
    from mpc_ilqr_tpu.models.robot import standing_state

    N, k, n_steps = 6, 2, 4
    jprob = jax_long_horizon
    x0 = standing_state(jprob.model)
    fx = np.load(os.path.join(ROOT, "tests", "torch_fixtures", "long_horizon_h1.npz"))
    jh = {f: fx[f] for f in ("solve_ok", "cost")}
    jxT = fx["xT"]

    prob, _ = scenarios.long_horizon(tuned=True, iters=1, solve_every=k, device="cpu")
    f32 = torch.float32
    tm = port_model(jprob.model, f32)
    tprob = prob._replace(model=tm, cp=port_cost_params(jprob.cp, f32),
                          refs=port_refs(jprob.refs, f32),
                          cfg=dataclasses.replace(prob.cfg, N=N))
    assert tprob.cfg.backward == "pallas"
    tstate, txT, th = scenarios.tvlqr_amortized_loop(
        tprob, k, tctl.init_state(tm, tprob.cfg), torch.tensor(np.asarray(x0)), n_steps)

    assert th["solve_ok"] == np.asarray(jh["solve_ok"]).tolist() == [True] * (n_steps // k)
    assert th["iterations"] == [1] * (n_steps // k)
    assert tstate.t_idx == int(fx["t_idx"]) == n_steps
    assert th["x"].shape == (n_steps, tm.nx) and th["u"].shape == (n_steps, tm.nu)
    np.testing.assert_allclose(txT.numpy(), np.asarray(jxT), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tstate.prev_xbar.numpy(), fx["prev_xbar"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tstate.prev_ubar.numpy(), fx["prev_ubar"], rtol=0, atol=5e-4)
    np.testing.assert_allclose(th["cost"].numpy(), np.asarray(jh["cost"]), rtol=1e-4)
    assert 1.0 < float(txT[2]) < 1.1
