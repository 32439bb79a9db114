"""The port on the card: the CUDA kernels (K1-K4) against their plain
versions, the wrappers' checks, the kernel gate, the flagship's first MPC
steps and a long-horizon step through K4. Every test here needs an NVIDIA
GPU and skips without one.

This file imports only torch, numpy, the port and chip_smoke (for its
Riccati problems), so it also runs on the GPU machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from chip_smoke import (RICCATI_REG, RICCATI_T_BAD, SEED_COST_RTOL, SEED_UBAR_ATOL,
                        riccati_problem)

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


def test_batched_chains_equal_single_alpha_launches_bit_for_bit(card):
    """K3 at A=7 is seven independent chains: each equals a K2 launch at its
    alpha alone, bit for bit (one block per chain, no atomics, no sums across
    chains)."""
    from mpc_ilqr_tpu_torch.ilqr.solver import ILQRConfig
    from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk

    m, plan = card
    x0, xbar, ubar, K, kff = _ls_inputs(m, 25)
    alphas = torch.tensor(ILQRConfig().alphas[1:], device="cuda")
    xs7, us7 = rk.linesearch_rollout_kernel_batched(m, plan, x0, xbar, ubar, K, kff, alphas)
    for a in range(alphas.shape[0]):
        xs1, us1 = rk.linesearch_rollout_kernel(m, plan, x0, xbar, ubar, K, kff,
                                                alphas[a:a + 1].contiguous())
        assert torch.equal(xs7[a], xs1[0]) and torch.equal(us7[a], us1[0])


def test_zero_feedback_chain_equals_open_chain_bit_for_bit(card):
    """K2 with K = 0, k = 0 and ū = us applies u_t = us_t exactly, so its
    states equal K1's bit for bit."""
    from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk

    m, plan = card
    x0, xbar, ubar, K, kff = _ls_inputs(m, 25)
    xs_open = rk.rollout_kernel(m, plan, x0, ubar)
    xs_fb, us_fb = rk.linesearch_rollout_kernel(m, plan, x0, xbar, ubar, torch.zeros_like(K),
                                                torch.zeros_like(kff),
                                                torch.ones(1, device="cuda"))
    assert torch.equal(xs_fb[0], xs_open) and torch.equal(us_fb[0], ubar)


def test_kernels_take_a_model_wider_than_a_warp():
    """h1_with_hand (46 bodies, nv=51 > 32 lanes, no contact points) takes the
    kernels' shared-memory factor and their loops over lanes. K1 and K2
    against their plain versions over 10 steps at atol 2e-4, the JAX
    package's kernel tolerance: without contact the float32 chains do not
    amplify round-off, so both sit far inside it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mpc_ilqr_tpu_torch.models.robot import load_robot
    from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk
    from mpc_ilqr_tpu_torch.ops.step_plan import build_step_plan

    m = load_robot(os.path.join(ROOT, "robots/h1_description/mjcf/h1_with_hand.xml"),
                   gravity=(0.0, 0.0, -1.0), timestep=0.02)
    assert (m.nv, m.ncp, m.nbody) == (51, 0, 46)
    plan = build_step_plan(m)
    x0, xbar, ubar, K, kff = _ls_inputs(m, 10)
    alphas = torch.tensor([1.0, 0.5], device="cuda")
    got = (rk.rollout_kernel(m, plan, x0, ubar),
           *rk.linesearch_rollout_kernel(m, plan, x0, xbar, ubar, K, kff, alphas))
    want = (rk.rollout_plain(m, x0, ubar),
            *rk.linesearch_rollout_plain(m, x0, xbar, ubar, K, kff, alphas))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
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


def _riccati_inputs(N, nx, nu, case="plain"):
    """chip_smoke.riccati_problem (tests/test_ops.py:14-26's random problem,
    with the bump cases) in float32 on the card."""
    return [torch.as_tensor(a, dtype=torch.float32, device="cuda")
            for a in riccati_problem(N, nx, nu, case)]


@pytest.mark.parametrize("N,nx,nu,reg,case", [(10, 51, 19, 1e-6, "plain"),
                                               (4, 13, 5, 1e-5, "plain"),
                                               (10, 51, 19, RICCATI_REG, "rescued"),
                                               (10, 51, 19, RICCATI_REG, "indefinite"),
                                               (3, 64, 32, 1e-6, "plain"),
                                               (3, 33, 7, 1e-6, "plain"),
                                               (1, 51, 19, 1e-6, "plain"),
                                               (10, 33, 7, RICCATI_REG, "rescued"),
                                               (10, 64, 32, RICCATI_REG, "indefinite"),
                                               (3, 103, 45, 1e-6, "plain"),
                                               (8, 103, 45, RICCATI_REG, "rescued"),
                                               (8, 103, 45, RICCATI_REG, "indefinite"),
                                               (3, 128, 64, 1e-6, "plain"),
                                               (10, 8, 64, RICCATI_REG, "rescued"),
                                               (3, 65, 3, 1e-6, "plain"),
                                               (3, 160, 80, 1e-6, "plain"),
                                               (8, 160, 80, RICCATI_REG, "rescued"),
                                               (8, 160, 80, RICCATI_REG, "indefinite"),
                                               (8, 128, 64, RICCATI_REG, "rescued")])
def test_riccati_kernel_matches_plain_and_counts_its_launch(card, N, nx, nu, reg, case):
    """K4 against its plain version at the JAX package's Riccati bar
    (rtol 2e-3, atol 2e-4, tests/test_ops.py:36-37), non-finite exactly where
    the plain version is; "rescued" puts an exact zero pivot at one step,
    where the PD bump must fire in the kernel too; "indefinite" a Quu the bump
    cannot cure, so every step from there down is NaN. (3, 64, 32) is the
    first design's largest size, (3, 33, 7) a ragged one and N=1 the
    shortest pass; the next two take the bump and its NaNs through the
    instantiation for every nu but H1's. The rest go through the wide
    design, a cluster of CTAs per instance: H1 with hands (103, 45) and its
    bump cases, (128, 64) and sizes past the narrow design's in one
    dimension only (4 CTAs each), and the limit (160, 80) with its bump
    cases (8)."""
    from mpc_ilqr_tpu_torch.ops import riccati

    args = _riccati_inputs(N, nx, nu, case)
    before = riccati.LAUNCHES["riccati"]
    K, k = riccati.backward_pass_kernel(*args, torch.tensor(reg, device="cuda"), 1e-4)
    torch.cuda.synchronize()
    assert riccati.LAUNCHES["riccati"] == before + 1
    K_p, k_p = riccati.backward_pass_plain(*args, reg, 1e-4)
    assert K.shape == (N, nu, nx) and k.shape == (N, nu) and K.is_cuda
    for got, want in ((K, K_p), (k, k_p)):
        fin = torch.isfinite(want)
        assert torch.equal(torch.isfinite(got), fin)
        assert bool(fin.all()) == (case != "indefinite")
        np.testing.assert_allclose(got[fin].cpu().numpy(), want[fin].cpu().numpy(), rtol=2e-3,
                                   atol=2e-4)
    if case == "rescued":  # without the bump k there would be NaN; with it, -lu / pd_bump
        assert abs(float(k[RICCATI_T_BAD, 3]) + float(args[3][RICCATI_T_BAD, 3]) / 1e-4) < 1.0
    if case == "indefinite":  # the steps from the indefinite one down, and only they
        bad = (~torch.isfinite(k)).any(1).cpu()
        assert bad.tolist() == [t <= RICCATI_T_BAD for t in range(N)]


@pytest.mark.parametrize("nx,nu", [(51, 19), (33, 7), (103, 45), (160, 80)])
def test_riccati_batch_is_one_launch_equal_to_single_launches(card, nx, nu):
    """torch.func.vmap of K4 over 3 instances with their own λ (one of them
    with the PD bump): one launch, no host sync, each instance's gains bit
    for bit those of its own single launch (a block computes its instance as
    the single launch does), through each design and instantiation."""
    from mpc_ilqr_tpu_torch.ops import riccati

    probs = [_riccati_inputs(10, nx, nu, c) for c in ("plain", "rescued", "plain")]
    arrs = [torch.stack([p[j] * (1.0 + 0.05 * i) if j < 2 else p[j] for i, p in enumerate(probs)])
            for j in range(6)]
    regs = torch.tensor([1e-6, RICCATI_REG, 1e-2], device="cuda")
    singles = [riccati.backward_pass_kernel(*(a[i] for a in arrs), regs[i], 1e-4)
               for i in range(3)]
    torch.cuda.synchronize()
    riccati.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        K, k = torch.func.vmap(lambda *a: riccati.backward_pass_kernel(*a[:6], a[6], 1e-4))(
            *arrs, regs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert riccati.LAUNCHES["riccati"] == 1 and K.shape == (3, 10, nu, nx)
    for i, (Ks, ks) in enumerate(singles):
        assert torch.equal(K[i], Ks) and torch.equal(k[i], ks), i
    assert bool(torch.isfinite(k[1]).all())  # the bump rescued the zero pivot


@pytest.mark.parametrize("N,nx,nu,reg,case", [(10, 13, 5, 1e-5, "plain"),
                                               (10, 51, 19, RICCATI_REG, "rescued"),
                                               (8, 103, 45, RICCATI_REG, "indefinite")])
def test_riccati_wide_entry_matches_plain_and_refuses_unaligned_rows(card, N, nx, nu, reg, case):
    """The wide design through its C entry point, also at sizes the narrow
    design takes, on rows padded as the op pads them: the bar against the
    plain version, non-finite exactly where it is. On the rows as they are
    (412 bytes at nx=103: no tensor copy takes them) both the wide entry and
    the batched one refuse the launch with cudaErrorInvalidValue. The
    clusters the op launches (4 CTAs at (103, 45), 8 at the limit) can be
    resident (cudaOccupancyMaxActiveClusters > 0)."""
    from mpc_ilqr_tpu_torch.ops import _build
    from mpc_ilqr_tpu_torch.ops import riccati

    lib = _build.library()
    assert lib.mpc_riccati_cluster(103, 45) == 4
    assert lib.mpc_riccati_cluster(riccati.MAX_NX, riccati.MAX_NU) == 8
    for size in ((103, 45), (riccati.MAX_NX, riccati.MAX_NU)):
        assert lib.mpc_riccati_active_clusters(*size) > 0, size
    args = _riccati_inputs(N, nx, nu, case)
    want = riccati.backward_pass_plain(*args, reg, 1e-4)
    reg_d = torch.tensor([reg], dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    K, k = torch.empty((N, nu, nx), device="cuda"), torch.empty((N, nu), device="cuda")

    def wide(ins, ldx, ldu):
        return lib.mpc_riccati_backward_wide(*(t.data_ptr() for t in ins), reg_d.data_ptr(),
                                             1e-4, K.data_ptr(), k.data_ptr(), ldx, ldu, 1, N,
                                             nx, nu, stream)

    assert wide(*riccati.pad_rows(*args)) == 0
    torch.cuda.synchronize()
    for got, ref in ((K, want[0]), (k, want[1])):
        fin = torch.isfinite(ref)
        assert torch.equal(torch.isfinite(got), fin)
        np.testing.assert_allclose(got[fin].cpu().numpy(), ref[fin].cpu().numpy(),
                                   rtol=2e-3, atol=2e-4)
    invalid = 1  # cudaErrorInvalidValue
    assert wide(args, nx, nu) == invalid
    if lib.mpc_riccati_cluster(nx, nu):
        assert lib.mpc_riccati_backward_batched(
            *(t.data_ptr() for t in args), reg_d.data_ptr(), 1e-4, K.data_ptr(), k.data_ptr(),
            None, 1, N, nx, nu, stream) == invalid


def test_riccati_kernel_matches_float64_on_the_long_horizon_inputs(card):
    """K4 on the long-horizon path's own inputs (N=100, chip_smoke's
    long_horizon_inputs) against the plain version in float64, K and kff
    each no further than atol + 2 |plain32 - plain64| (chip_smoke phase 5's
    bar): a 100-step recursion with |K| up to ~1e3 sits at float32's floor,
    so plain float32 itself is the yardstick."""
    from chip_smoke import RICCATI_ATOL, long_horizon_inputs
    from mpc_ilqr_tpu_torch.ops import riccati

    li = long_horizon_inputs()
    args, cfg = li["args"], li["prob"].cfg
    reg = torch.tensor(cfg.reg_init, device="cuda")
    got = riccati.backward_pass_kernel(*args, reg, cfg.pd_bump)
    p32 = riccati.backward_pass_plain(*args, reg, cfg.pd_bump)
    p64 = riccati.backward_pass_plain(*[a.double() for a in args], cfg.reg_init, cfg.pd_bump)
    for g, w32, w64 in zip(got, p32, p64):
        assert bool(torch.isfinite(g).all())
        bar = RICCATI_ATOL + 2.0 * float((w32.double() - w64).abs().max())
        assert float((g.double() - w64).abs().max()) <= bar


def test_riccati_wrapper_raises_on_what_the_kernel_does_not_take(card):
    from mpc_ilqr_tpu_torch.ops import riccati

    args = _riccati_inputs(4, 13, 5)
    with pytest.raises(ValueError):  # float64
        riccati.backward_pass_kernel(*(a.double() for a in args), 1e-6, 1e-4)
    with pytest.raises(ValueError):  # non-contiguous luu
        riccati.backward_pass_kernel(*args[:5], args[5].transpose(1, 2), 1e-6, 1e-4)
    with pytest.raises(ValueError):  # nx above the kernel's maximum
        riccati.backward_pass_kernel(*_riccati_inputs(2, riccati.MAX_NX + 1, 5), 1e-6, 1e-4)
    with pytest.raises(ValueError):  # nu above the kernel's maximum
        riccati.backward_pass_kernel(*_riccati_inputs(2, 13, riccati.MAX_NU + 1), 1e-6, 1e-4)


def test_long_horizon_step_runs_through_k4(card):
    """One MPC step of the tuned long-horizon path (N=100, backward
    "pallas"): the solve is ok, the plant stays near standing and every
    backward pass was a K4 launch (inner_attempts=1: one per iteration)."""
    from mpc_ilqr_tpu_torch import scenarios
    from mpc_ilqr_tpu_torch.models.robot import standing_state
    from mpc_ilqr_tpu_torch.mpc import controller
    from mpc_ilqr_tpu_torch.ops import riccati
    from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk

    prob, _ = scenarios.long_horizon(tuned=True)
    assert prob.cfg.N == 100 and prob.cfg.backward == "pallas" and prob.cfg.inner_attempts == 1
    riccati.reset_launch_counts()
    rk.reset_launch_counts()
    _, xT, hist = controller.run_closed_loop(prob.model, prob.cp, prob.cfg, prob.refs,
                                             controller.init_state(prob.model, prob.cfg),
                                             standing_state(prob.model), 1, plan=prob.plan)
    torch.cuda.synchronize()
    assert hist["solve_ok"] == [True] and bool(torch.isfinite(xT).all())
    assert 1.0 < float(xT[2]) < 1.1
    assert riccati.LAUNCHES["riccati"] == hist["iterations"][0] >= 1
    assert rk.LAUNCHES["rollout"] >= 1 and rk.LAUNCHES["linesearch"] >= 1


def test_run_simulation_walks_on_the_card_with_the_native_logger(card, tmp_path):
    """The entry point on the card: three sim steps of config.yaml as
    shipped (walking), through the native step log and the trajectory logs:
    every row written and none dropped, the reference's headers, finite
    states near standing, and the solver's rollouts through K1 and K2."""
    from chip_smoke import walking_quality
    from mpc_ilqr_tpu_torch.io import logging as iolog
    from mpc_ilqr_tpu_torch.io.config import load_config
    from mpc_ilqr_tpu_torch.mpc import runner
    from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk
    from mpc_ilqr_tpu_torch.utils.profiling import Profiler

    prob = runner.setup(load_config(os.path.join(ROOT, "config.yaml")))
    m = prob.model
    assert m.device.type == "cuda" and prob.refs.length == 400
    step_logger = iolog.StepLogger(str(tmp_path / "mpc_log.csv"), m.nx, m.nu)
    traj_logger = iolog.OptimalTrajectoryLogger(str(tmp_path / "results"), m.nq, m.nu)
    assert step_logger.native
    prof = Profiler()
    rk.reset_launch_counts()
    hist, state = runner.run_simulation(prob, sim_steps=3, verbose=False, profiler=prof,
                                        step_logger=step_logger, traj_logger=traj_logger)
    assert len(hist["cost"]) == 3 and state.t_idx == 3
    assert step_logger.dropped == 0 and len(prof.times["MPC_stepOnce"]) == 3
    q = walking_quality(str(tmp_path / "mpc_log.csv"))
    assert q["rows"] == 3 and q["header"] == step_logger.header
    assert 1.0 < q["z_min"] and q["z_max"] < 1.1
    assert all(np.isfinite(x).all() for x in hist["x"])
    for name in ("q_optimal.csv", "u_optimal.csv"):
        assert len((tmp_path / "results" / name).read_text().splitlines()) == 4
    assert rk.LAUNCHES["rollout"] >= 1 and rk.LAUNCHES["linesearch"] >= 1


def test_load_state_defaults_to_the_card(card, tmp_path):
    from mpc_ilqr_tpu_torch.mpc import checkpoint, controller
    from mpc_ilqr_tpu_torch.ilqr.solver import ILQRConfig

    m, _ = card
    state = controller.init_state(m, ILQRConfig(N=5, linearization="structured_frozen_mass",
                                                quad_mode="gn"))
    checkpoint.save_state(str(tmp_path / "s.npz"), state.replace(t_idx=4, has_prev=True))
    back = checkpoint.load_state(str(tmp_path / "s.npz"))
    assert back.prev_K.device.type == back.reg.device.type == "cuda"
    assert (back.t_idx, back.has_prev) == (4, True)
    assert torch.equal(back.prev_xbar, state.prev_xbar)


def test_profiler_stage_waits_for_a_cuda_output(card):
    """A stage whose output is still being computed on the card ends only
    when the card is done: an event recorded after the work has completed
    when the stage returns."""
    from mpc_ilqr_tpu_torch.utils.profiling import Profiler

    a = torch.randn(4096, 4096, device="cuda")
    torch.cuda.synchronize()
    prof, out = Profiler(), []
    done = torch.cuda.Event()
    with prof.stage("matmuls", block_on=out):
        y = a
        for _ in range(20):
            y = y @ a / 64.0
        out.append({"y": (y,)})
        done.record()
    assert done.query()
    assert len(prof.times["matmuls"]) == 1
    assert "Card peak allocated" in prof.report()


def test_fleet_of_8_steps_on_the_card_without_a_host_sync(card):
    """scenarios.fleet at 8 instances (N=25): the cold step, then the warm
    step under sync-debug "error" (no host sync), finite controls, every
    output on the card and no kernel launched (the plain chains)."""
    from mpc_ilqr_tpu_torch import scenarios
    from mpc_ilqr_tpu_torch.ops import riccati
    from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk
    from mpc_ilqr_tpu_torch.parallel import fleet

    fl = scenarios.fleet(n=8)
    assert fl.chunk == 8 and fl.prob.cfg.N == 25 and fl.prob.cfg.rollout_solver == "masked"
    rk.reset_launch_counts()
    riccati.reset_launch_counts()
    step = lambda s: fleet.fleet_step_chunked(fl.models, fl.prob.cp, fl.prob.cfg, fl.prob.refs,
                                              s, fl.xs, fl.chunk)
    states, u, diag = step(fl.states)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        states, u, diag = step(states)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert u.shape == (8, fl.prob.model.nu) and u.device.type == "cuda"
    assert states.prev_K.device.type == diag.cost.device.type == "cuda"
    assert bool(torch.isfinite(u).all()) and bool(torch.isfinite(diag.cost).all())
    assert bool(states.has_prev.all())
    assert not any(rk.LAUNCHES.values()) and not any(riccati.LAUNCHES.values())


def test_fleet_of_8_with_k4_launches_once_per_attempt_without_a_host_sync(card):
    """scenarios.fleet at 8 instances with backward "pallas": the warm step
    under sync-debug "error", K4 launched once per attempt of every trip
    (one launch for the 8 instances), finite controls, and the same
    solve_ok count as backward "scan" with controls within chip_smoke's
    batched bar."""
    import dataclasses

    from mpc_ilqr_tpu_torch import scenarios
    from mpc_ilqr_tpu_torch.ops import riccati
    from mpc_ilqr_tpu_torch.parallel import fleet

    fl = scenarios.fleet(n=8)
    cfg = dataclasses.replace(fl.prob.cfg, backward="pallas")
    step = lambda c, s: fleet.fleet_step_chunked(fl.models, fl.prob.cp, c, fl.prob.refs, s, fl.xs,
                                                 fl.chunk)
    states, _, _ = step(cfg, fl.states)
    torch.cuda.synchronize()
    riccati.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, u, diag = step(cfg, states)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert riccati.LAUNCHES["riccati"] == cfg.max_iterations * cfg.inner_attempts
    _, u_s, diag_s = step(fl.prob.cfg, states)
    assert bool(torch.isfinite(u).all())
    assert int(diag.solve_ok.sum()) == int(diag_s.solve_ok.sum())
    assert float((u - u_s).abs().max()) <= SEED_UBAR_ATOL


def test_batched_seed_solve_equals_one_seed_at_a_time(card):
    """solve_batched over 2 seeds of scenarios.batched_linesearch (16
    alphas, N=25) against device_solve on each seed alone, at chip_smoke's
    float32 bars."""
    from mpc_ilqr_tpu_torch import scenarios
    from mpc_ilqr_tpu_torch.ilqr import solver

    ss = scenarios.batched_linesearch(n_seeds=2)
    p = ss.prob
    sol = solver.solve_batched(p.model, p.cp, p.cfg, ss.x0, ss.window, ss.seeds)
    assert sol.cost.device.type == "cuda" and bool(torch.isfinite(sol.cost).all())
    cfg = solver.batched_config(p.cfg)
    for s in range(2):
        one = solver.device_solve(p.model, p.cp, cfg, ss.x0, ss.window, ss.seeds[s])
        rel = abs(float(one.cost) - float(sol.cost[s])) / max(1.0, abs(float(one.cost)))
        assert rel <= SEED_COST_RTOL
        assert float((one.ubar - sol.ubar[s]).abs().max()) <= SEED_UBAR_ATOL


def test_masked_spd_solve_on_the_card_equals_the_cpu(card):
    """ops/linalg.spd_solve on H1-sized (25x25) SPD batches, float32: the
    card's result against the CPU's on the same inputs, at atol 2e-4."""
    from mpc_ilqr_tpu_torch.ops import linalg

    rng = np.random.default_rng(0)
    M = rng.normal(size=(64, 25, 25))
    A = torch.as_tensor(M @ np.swapaxes(M, -1, -2) + 25 * np.eye(25), dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=(64, 25, 3)), dtype=torch.float32)
    got = linalg.spd_solve(A.cuda(), b.cuda())
    want = linalg.spd_solve(A, b)
    assert got.device.type == "cuda"
    assert float((got.cpu() - want).abs().max()) <= ATOL
    assert float((A @ want - b).abs().max()) <= ATOL


def _exact_problem64(device):
    """scenarios.exact_standing ("ad" + "exact") in float64 on the plain
    chains (the kernels take float32) with first_accept, N=6."""
    from mpc_ilqr_tpu_torch import scenarios

    app = _standing_app()
    app.engine.update(dtype="float64", rollout_backend="xla", ls_backend="xla",
                      line_search="first_accept")
    return scenarios.exact_standing(app, device=device, N=6, max_iterations=3)


def test_exact_solve_on_the_card_equals_the_cpu_in_float64(card):
    """One solve with linearization "ad", quad_mode "exact" and cost_mode
    "full" from gravity compensation at the standing state: the card's
    iterations, success, cost and trajectory against the CPU's, float64."""
    import dataclasses

    from mpc_ilqr_tpu_torch.costs.references import extract_window
    from mpc_ilqr_tpu_torch.dynamics import engine
    from mpc_ilqr_tpu_torch.ilqr import solver
    from mpc_ilqr_tpu_torch.models.robot import standing_state

    sols = []
    for device in ("cuda", "cpu"):
        p = _exact_problem64(device)
        cfg = dataclasses.replace(p.cfg, cost_mode="full")
        x0 = standing_state(p.model)
        u0 = engine.gravity_comp(p.model, x0)[None].repeat(cfg.N, 1)
        sols.append(solver.solve(p.model, p.cp, cfg, x0, extract_window(p.refs, 0, cfg.N), u0))
    got, want = sols
    assert got.cost.device.type == "cuda" and got.success and want.success
    assert got.iterations == want.iterations
    assert abs(float(got.cost) - float(want.cost)) <= 1e-9 * max(1.0, abs(float(want.cost)))
    for f in ("xbar", "ubar", "K"):
        assert float((getattr(got, f).cpu() - getattr(want, f)).abs().max()) <= 1e-8, f


def test_fd_against_ad_on_the_card(card):
    """tests/test_linearize_fd.py:12-24 on the card: load_h1's contact, the
    standing state at gravity compensation, N=3, float64; "fd" (fd_eps
    1e-6) within 5e-4 of "ad"."""
    from mpc_ilqr_tpu_torch.dynamics import engine
    from mpc_ilqr_tpu_torch.ilqr import solver
    from mpc_ilqr_tpu_torch.models.robot import standing_state

    m = card[0].to(dtype=torch.float64)
    cfg = solver.ILQRConfig(N=3, linearization="ad")
    x0 = standing_state(m)
    us = engine.gravity_comp(m, x0)[None].repeat(3, 1)
    xs = solver.rollout(m, cfg, x0, us)
    A, B = solver.linearize(m, cfg, xs, us)
    Af, Bf = solver.linearize(m, solver.ILQRConfig(N=3, linearization="fd", fd_eps=1e-6), xs, us)
    assert A.device.type == "cuda" and bool(torch.isfinite(A).all())
    assert float((Af - A).abs().max()) <= 5e-4 and float((Bf - B).abs().max()) <= 5e-4


def test_assoc_riccati_on_the_card_raises_and_syncs_nothing(card):
    """backward_pass_assoc on CUDA, float32, H1's sizes at N=100
    (chip_smoke.riccati_problem) and with an indefinite knot, under
    sync-debug "error": no host sync and no raise; against its run on the
    CPU on the same inputs at the JAX package's Riccati bar (rtol 2e-3,
    atol 2e-4); the indefinite knot alone non-finite on both."""
    from mpc_ilqr_tpu_torch.costs.quadratics import CostQuadratics
    from mpc_ilqr_tpu_torch.ops.assoc_riccati import backward_pass_assoc

    for case in ("plain", "indefinite"):
        args = [torch.as_tensor(a, dtype=torch.float32) for a in
                riccati_problem(100, 51, 19, case)]
        run = lambda ts, reg: backward_pass_assoc(ts[0], ts[1], CostQuadratics(*ts[2:]), reg,
                                                  1e-4)
        on_card = [a.cuda() for a in args]
        reg = torch.full((), RICCATI_REG, device="cuda")
        run(on_card, reg)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = run(on_card, reg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want = run(args, torch.tensor(RICCATI_REG))
        for g, w in zip(got, want):
            g = g.cpu()
            assert torch.equal(torch.isfinite(g), torch.isfinite(w)), case
            fin = torch.isfinite(w)
            assert bool(((g - w).abs()[fin] <= 2e-4 + 2e-3 * w.abs()[fin]).all()), case
        bad = (~torch.isfinite(got[1])).any(1).nonzero().flatten().tolist()
        assert bad == ([] if case == "plain" else [RICCATI_T_BAD]), (case, bad)


def test_world_one_nccl_sharded_line_search_equals_the_local_one(card):
    """A world-1 NCCL group and make_mesh(1): the sharded line search (K3
    over all the alphas, one all_gather) against `line_search` with the
    same config, first_accept and argmin, on chip_smoke's kernel inputs of
    the standing flagship: equal to the last bit."""
    import dataclasses
    import datetime

    import torch.distributed as dist

    from chip_smoke import kernel_inputs, standing_problem
    from mpc_ilqr_tpu_torch.costs.quadratics import trajectory_cost
    from mpc_ilqr_tpu_torch.costs.references import extract_window
    from mpc_ilqr_tpu_torch.ilqr import solver
    from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk
    from mpc_ilqr_tpu_torch.parallel.sharded_solve import sharded_line_search
    from mpc_ilqr_tpu_torch.parallel.sharding import make_mesh
    from torch_dist_ranks import free_port

    p = standing_problem()
    i = kernel_inputs(p.model, p.cfg.alphas, p.cfg.N)
    win = extract_window(p.refs, 0, p.cfg.N)
    base = trajectory_cost(p.model, p.cp, win, i["xbar"], i["ubar"])
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=120),
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = make_mesh(1)
        assert tuple(mesh.shape) == (1, 1)
        for mode in ("first_accept", "argmin"):
            cfg = dataclasses.replace(p.cfg, line_search=mode, ls_backend="pallas_batched")
            args = (win, i["x0"], i["xbar"], i["ubar"], i["K"], i["kff"], base)
            rk.reset_launch_counts()
            got = sharded_line_search(mesh, p.model, p.cp, cfg, plan=p.plan)(*args)
            torch.cuda.synchronize()
            assert rk.LAUNCHES["linesearch_batched"] == 1
            want = solver.line_search(p.model, p.cp, cfg, *args, plan=p.plan)
            assert got[0] == want[0]
            for g, w in zip(got[1:], want[1:]):
                assert g.device.type == "cuda" and torch.equal(g, w), mode
    finally:
        dist.destroy_process_group()


def test_quat_frames_on_the_card(card):
    """quat_frames on H1, float64, on the card: against forward_kinematics
    at the JAX test's bar (atol 1e-12, rtol 1e-7) and against its run on
    the CPU at 1e-12."""
    from mpc_ilqr_tpu_torch.dynamics import math as qm
    from mpc_ilqr_tpu_torch.dynamics.kinematics import forward_kinematics
    from mpc_ilqr_tpu_torch.models.robot import load_h1
    from mpc_ilqr_tpu_torch.ops.quat_fk import build_level_plans, quat_frames

    rng = np.random.default_rng(11)
    q = np.zeros(26)
    q[:3] = rng.normal(size=3)
    quat = rng.normal(size=4)
    q[3:7] = quat / np.linalg.norm(quat)
    q[7:] = rng.normal(0, 0.5, 19)
    out = {}
    for device in ("cuda", "cpu"):
        m = load_h1(dtype=torch.float64, device=device)
        qt = torch.as_tensor(q, device=device)
        out[device] = quat_frames(m, build_level_plans(m), qt)
        if device == "cuda":
            fr = forward_kinematics(m, qt)
            Q, P = out[device]
            assert Q.device.type == "cuda"
            assert bool(((P - fr.p).abs() <= 1e-12 + 1e-7 * fr.p.abs()).all())
            R = qm.quat_to_mat(Q)
            assert bool(((R - fr.R).abs() <= 1e-12 + 1e-7 * fr.R.abs()).all())
    for g, w in zip(out["cuda"], out["cpu"]):
        assert float((g.cpu() - w).abs().max()) <= 1e-12
