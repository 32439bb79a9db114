"""The port on the card: the CUDA rollout kernels against their plain
versions, the wrappers' checks, the kernel gate and the flagship's first MPC
steps. Every test here needs an NVIDIA GPU and skips without one.

This file imports only torch, numpy and the port, so it also runs on the GPU
machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-4  # the JAX package's kernel tolerance, tests/test_ops.py:165, :214
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mpc_ilqr_tpu_torch.models.robot import load_h1
    from mpc_ilqr_tpu_torch.ops.step_plan import build_step_plan

    m = load_h1(gravity=(0.0, 0.0, -1.0), timestep=0.02)  # the reference kernel tests' model
    return m, build_step_plan(m)


def _standing_app():
    from mpc_ilqr_tpu_torch.io.config import load_config

    app = load_config(os.path.join(ROOT, "config.yaml"))
    app.q_ref_path = "data/q_standing.csv"
    app.v_ref_path = "data/v_standing.csv"
    app.contact_schedule_path = "data/contact_standing.csv"
    return app


def _ls_inputs(m, N, seed=0):
    """tests/test_ops.py:181-193 at horizon N."""
    from mpc_ilqr_tpu_torch.dynamics import engine
    from mpc_ilqr_tpu_torch.models.robot import standing_state
    from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk

    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    x0 = standing_state(m)
    ubar = (engine.gravity_comp(m, x0)[None] + t(0.1 * rng.normal(0, 1, (N, m.nu)))).contiguous()
    xbar = rk.rollout_plain(m, x0, ubar).contiguous()
    K = t(0.01 * rng.normal(0, 1, (N, m.nu, m.nx)))
    kff = t(0.1 * rng.normal(0, 1, (N, m.nu)))
    return x0, xbar, ubar, K, kff


@pytest.mark.parametrize("which", ["rollout", "linesearch", "linesearch_batched"])
def test_kernel_matches_plain_and_counts_its_launch(card, which):
    """Each kernel at the main path's shapes (N=25; A=1 and the 7 fallback
    alphas) against its plain version on the card."""
    from mpc_ilqr_tpu_torch.ilqr.solver import ILQRConfig
    from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk

    m, plan = card
    x0, xbar, ubar, K, kff = _ls_inputs(m, 25)
    alphas = torch.tensor(ILQRConfig().alphas, device="cuda")
    before = dict(rk.LAUNCHES)
    if which == "rollout":
        got, want = (rk.rollout_kernel(m, plan, x0, ubar),), (rk.rollout_plain(m, x0, ubar),)
    elif which == "linesearch":
        got = rk.linesearch_rollout_kernel(m, plan, x0, xbar, ubar, K, kff, alphas[:1])
        want = rk.linesearch_rollout_plain(m, x0, xbar, ubar, K, kff, alphas[:1])
    else:
        got = rk.linesearch_rollout_kernel_batched(m, plan, x0, xbar, ubar, K, kff, alphas[1:])
        want = rk.linesearch_rollout_batched_plain(m, x0, xbar, ubar, K, kff, alphas[1:])
    torch.cuda.synchronize()
    assert rk.LAUNCHES[which] == before[which] + 1
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape and g.is_contiguous()
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0, atol=ATOL)


def test_one_step_matches_float64_on_the_main_path_model():
    """One step of K1 from perturbed, in-contact states of the config.yaml
    model: as close to the float64 plain step as the float32 plain step is
    (single steps do not yet amplify round-off; both sit near 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mpc_ilqr_tpu_torch.dynamics import engine
    from mpc_ilqr_tpu_torch.mpc import runner
    from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk

    prob = runner.setup(_standing_app())
    m, plan = prob.model, prob.plan
    m64 = m.to(dtype=torch.float64)
    for seed in range(4):
        rng = np.random.default_rng(seed)
        x = np.zeros(m.nx)
        x[2], x[3] = 0.98, 1.0
        x[7 : m.nq] += rng.normal(0, 0.2, m.nq - 7)
        x[m.nq :] += rng.normal(0, 0.3, m.nv)
        xt = torch.tensor(x, dtype=torch.float32, device="cuda")
        ut = torch.tensor(rng.normal(0, 3.0, m.nu), dtype=torch.float32, device="cuda")
        got = rk.rollout_kernel(m, plan, xt, ut[None].contiguous())[1].double()
        want = engine.step(m64, xt.double(), ut.double())
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("which", ["rollout", "linesearch", "linesearch_batched"])
def test_kernel_matches_float64_in_the_stiction_regime(which):
    """Two steps of each kernel on the config.yaml model (impratio 100) from
    the standing state: all contact points down, |v_t| at 0 then ~2e-5, where
    the stiction regularisation 1e-6/impratio sets the friction law. Round-off
    has not grown yet (plain float32 is within about 5e-5 of float64,
    tools/port_f32_floor.py), so the kernel is held to float64 at the kernel
    tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mpc_ilqr_tpu_torch.dynamics import engine
    from mpc_ilqr_tpu_torch.ilqr.solver import ILQRConfig
    from mpc_ilqr_tpu_torch.mpc import runner
    from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk

    prob = runner.setup(_standing_app())
    m, plan = prob.model, prob.plan
    m64 = m.to(dtype=torch.float64)
    x0, xbar, ubar, K, kff = _ls_inputs(m, 2)
    alphas = torch.tensor(ILQRConfig().alphas, device="cuda")
    if which == "rollout":
        us = engine.gravity_comp(m, x0)[None].repeat(2, 1).contiguous()
        got, want = (rk.rollout_kernel(m, plan, x0, us),), (rk.rollout_plain(m64, x0.double(),
                                                                            us.double()),)
    else:
        a = alphas[:1] if which == "linesearch" else alphas[1:]
        kern = (rk.linesearch_rollout_kernel if which == "linesearch"
                else rk.linesearch_rollout_kernel_batched)
        got = kern(m, plan, x0, xbar, ubar, K, kff, a)
        want = rk.linesearch_rollout_plain(m64, *[t.double() for t in (x0, xbar, ubar, K, kff, a)])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.double().cpu().numpy(), w.cpu().numpy(), rtol=0, atol=ATOL)


def test_wrappers_raise_on_what_the_kernel_does_not_take(card):
    from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk

    m, plan = card
    x0 = torch.zeros(m.nx, device="cuda")
    us = torch.zeros((4, m.nu), device="cuda")
    with pytest.raises(ValueError):  # float64
        rk.rollout_kernel(m, plan, x0.double(), us.double())
    with pytest.raises(ValueError):  # non-contiguous
        rk.rollout_kernel(m, plan, x0, torch.zeros((m.nu, 4), device="cuda").T)
    with pytest.raises(ValueError):  # no plan
        rk.rollout_kernel(m, None, x0, us)
    with pytest.raises(ValueError):  # wrong shape
        rk.rollout_kernel(m, plan, x0[:-1], us)


BALL_XML = """<mujoco><option timestep="0.02"/><worldbody>
  <body name="a" pos="0 0 1"><inertial pos="0 0 -0.2" mass="1" diaginertia="0.1 0.1 0.1"/>
    <joint name="j" type="ball"/>
    <body name="b" pos="0 0 -0.4"><inertial pos="0 0 -0.2" mass="1" diaginertia="0.1 0.1 0.1"/>
      <joint name="k" axis="0 1 0"/></body></body></worldbody>
  <actuator><motor joint="k"/></actuator></mujoco>"""


def test_gate_raises_for_models_the_kernels_cannot_take(card, tmp_path):
    from mpc_ilqr_tpu_torch.ilqr.solver import ILQRConfig
    from mpc_ilqr_tpu_torch.models.robot import load_robot
    from mpc_ilqr_tpu_torch.mpc import runner

    p = tmp_path / "ball.xml"
    p.write_text(BALL_XML)
    cfg = ILQRConfig(rollout_backend="pallas")
    with pytest.raises(NotImplementedError):
        runner.build_plan_gated(load_robot(str(p)), cfg, torch.float32)
    with pytest.raises(ValueError):
        runner.build_plan_gated(load_robot(str(p), dtype=torch.float64), cfg, torch.float64)


def test_flagship_steps_through_the_kernels(card):
    """Three MPC steps of the flagship on the card: every solve ok, base z
    near standing, and the solver's rollouts went through K1 and K2."""
    from mpc_ilqr_tpu_torch.models.robot import standing_state
    from mpc_ilqr_tpu_torch.mpc import controller, runner
    from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk

    prob = runner.setup(_standing_app())
    rk.reset_launch_counts()
    _, xT, hist = controller.run_closed_loop(prob.model, prob.cp, prob.cfg, prob.refs,
                                             controller.init_state(prob.model, prob.cfg),
                                             standing_state(prob.model), 3, plan=prob.plan)
    torch.cuda.synchronize()
    assert all(hist["solve_ok"]) and bool(torch.isfinite(hist["x"]).all())
    assert 1.0 < float(xT[2]) < 1.1
    assert rk.LAUNCHES["rollout"] >= 1 and rk.LAUNCHES["linesearch"] >= 1
