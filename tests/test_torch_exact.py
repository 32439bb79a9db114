"""Port parity, float64 on the CPU: the reference's exact-derivative solver
options — linearization "ad", "ad_frozen_mass" and "fd" with lin_chunk,
quad_mode "exact" with hess_chunk, cost_mode "full" — in
mpc_ilqr_tpu_torch against mpc_ilqr_tpu, both built from the same numpy
arrays.

On conftest's tiny arm the JAX side runs live (it compiles in seconds); the
arm's cost gets CoM weights so that "full" and the exact Hessian see the
kinematics. The arm has no free base and no end-effectors, so H1's upright,
balance and EE terms are held to tests/torch_fixtures/exact_h1.npz
(tools/port_exact_fixture.py: compiling H1's exact Hessian takes minutes).

Tolerances: 1e-9 where both sides compute the same float64 expression in
another operation order; "fd" divides that order's ~1e-15 by fd_eps, so it
is held at 1e-6, the JAX suite's own bar for a reordered "fd"
(tests/test_linearize_fd.py:132); chunked against full width at that
file's 1e-8 (1e-6 for "fd"), and the exact quadratics' chunks and modes
at tests/test_costs.py's bars (lxx 1e-9, lx/lu/luu exact).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ilqr_tpu.costs import quadratics as jquad
from mpc_ilqr_tpu.costs.references import extract_window as j_extract_window
from mpc_ilqr_tpu.ilqr import solver as jsol
from mpc_ilqr_tpu_torch.costs import quadratics as tquad
from mpc_ilqr_tpu_torch.costs import terms as tterms
from mpc_ilqr_tpu_torch.costs.references import ReferenceWindow, extract_window
from mpc_ilqr_tpu_torch.dynamics import engine
from mpc_ilqr_tpu_torch.ilqr import solver as tsol
from mpc_ilqr_tpu_torch.models.robot import standing_state
from mpc_ilqr_tpu_torch.mpc import controller as tctl
from test_torch_common import ROOT, port_cost_params, port_model, port_refs, standing_problem

FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "exact_h1.npz")
T64 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
LIN_TOL = {"ad": 1e-9, "ad_frozen_mass": 1e-9, "fd": 1e-6}
CHUNK_TOL = {"ad": 1e-8, "ad_frozen_mass": 1e-8, "fd": 1e-6, "structured": 1e-8,
             "structured_frozen_mass": 1e-8}
SOL_FIELDS = ("xbar", "ubar", "K", "kff", "cost", "reg")


def close(got, want, atol, msg=""):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got, np.asarray(want),
                               rtol=0, atol=atol, err_msg=msg)


# ---- the tiny arm, JAX live ------------------------------------------------------

@pytest.fixture(scope="module")
def arm(tiny_arm):
    """conftest's 2-dof arm in float64 with CoM weights (w_com 2, w_com_vel
    0.5), on both sides from the same arrays; a seeded nominal: x0, us and
    the reference's rollout xbar at N=4."""
    jm, cp, refs = jax.tree.map(
        lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a, tiny_arm)
    cp = cp.replace(w_com=jnp.asarray(2.0), w_com_vel=jnp.asarray(0.5))
    N = 4
    x0 = np.array([0.3, -0.4, 0.5, -0.2])
    us = np.random.default_rng(5).normal(0.0, 2.0, (N, jm.nu))
    xbar = np.asarray(jax.jit(lambda a, b: jsol.rollout(jm, jsol.ILQRConfig(N=N), a, b))(
        jnp.asarray(x0), jnp.asarray(us)))
    return dict(jm=jm, cp=cp, refs=refs, tm=port_model(jm), tcp=port_cost_params(cp),
                trefs=port_refs(refs), N=N, x0=x0, us=us, xbar=xbar,
                win=j_extract_window(refs, jnp.zeros((), jnp.int32), N))


@pytest.mark.parametrize("chunk", [0, 4], ids=["full_width", "lin_chunk_4"])
@pytest.mark.parametrize("mode", ["ad", "ad_frozen_mass", "fd"])
def test_linearize_matches_reference_on_the_arm(arm, mode, chunk):
    """A, B at every knot; lin_chunk 4 does not divide nx+nu = 6 (the
    reference pads the last group)."""
    kw = dict(N=arm["N"], linearization=mode, lin_chunk=chunk)
    jcfg = jsol.ILQRConfig(**kw)
    A, B = jax.jit(lambda a, b: jsol.linearize(arm["jm"], jcfg, a, b))(
        jnp.asarray(arm["xbar"]), jnp.asarray(arm["us"]))
    tA, tB = tsol.linearize(arm["tm"], tsol.ILQRConfig(**kw), T64(arm["xbar"]), T64(arm["us"]))
    close(tA, A, LIN_TOL[mode], "A")
    close(tB, B, LIN_TOL[mode], "B")


@pytest.mark.parametrize("chunk", [0, 3], ids=["full_width", "hess_chunk_3"])
def test_quadraticize_exact_matches_reference_on_the_arm(arm, chunk):
    q = jax.jit(lambda a, b: jquad.quadraticize(arm["jm"], arm["cp"], arm["win"], a, b,
                                                hess_chunk=chunk))(
        jnp.asarray(arm["xbar"]), jnp.asarray(arm["us"]))
    tq = tquad.quadraticize(arm["tm"], arm["tcp"], extract_window(arm["trefs"], 0, arm["N"]),
                            T64(arm["xbar"]), T64(arm["us"]), hess_chunk=chunk)
    for name, a, b in zip(jquad.CostQuadratics._fields, q, tq):
        close(b, a, 1e-9, name)


@pytest.mark.parametrize("mode", ["reference", "full"])
def test_trajectory_cost_matches_reference_on_the_arm(arm, mode):
    want = float(jax.jit(lambda a, b: jquad.trajectory_cost(arm["jm"], arm["cp"], arm["win"], a, b,
                                                           mode=mode))(
        jnp.asarray(arm["xbar"]), jnp.asarray(arm["us"])))
    twin = extract_window(arm["trefs"], 0, arm["N"])
    got = tquad.trajectory_cost(arm["tm"], arm["tcp"], twin, T64(arm["xbar"]), T64(arm["us"]),
                                mode=mode)
    assert abs(float(got) - want) <= 1e-12 * max(1.0, abs(want))
    batch = tquad.trajectory_costs(arm["tm"], arm["tcp"], twin, T64(arm["xbar"])[None],
                                   T64(arm["us"])[None], mode=mode)
    assert abs(float(batch[0]) - want) <= 1e-12 * max(1.0, abs(want))


EXACT_SOLVE = dict(N=4, max_iterations=3, tolerance=1e-6, linearization="ad",
                   quad_mode="exact", cost_mode="full", alphas=(1.0, 0.5, 0.1, 0.02))


def _reference_solve(arm, cfg):
    return jax.jit(lambda x, u: jsol.solve(arm["jm"], arm["cp"], cfg, x, arm["win"], u))(
        jnp.asarray(arm["x0"]), jnp.asarray(arm["us"]))


def _check_solution(got, want, atol=1e-9):
    assert int(got.iterations) == int(want.iterations)
    assert bool(got.success) == bool(want.success)
    for f in SOL_FIELDS:
        close(getattr(got, f), getattr(want, f), atol, f)


def test_exact_solve_matches_reference_on_the_arm(arm):
    """ad + exact + cost_mode "full": iterations, success, xbar, ubar, K,
    kff, cost and λ against the reference's solve."""
    want = _reference_solve(arm, jsol.ILQRConfig(**EXACT_SOLVE))
    got = tsol.solve(arm["tm"], arm["tcp"], tsol.ILQRConfig(**EXACT_SOLVE), T64(arm["x0"]),
                     extract_window(arm["trefs"], 0, arm["N"]), T64(arm["us"]))
    _check_solution(got, want)
    assert got.success and got.iterations >= 2
    assert float(got.cost) < float(tquad.trajectory_cost(
        arm["tm"], arm["tcp"], extract_window(arm["trefs"], 0, arm["N"]),
        tsol.rollout(arm["tm"], tsol.ILQRConfig(**EXACT_SOLVE), T64(arm["x0"]), T64(arm["us"])),
        T64(arm["us"]), mode="full"))


def test_exact_device_solve_matches_reference_on_the_arm(arm):
    """device_solve on the same problem against the reference's solve of
    vmap_safe(cfg) (its fixed-trip "scan" form), with the chunks set."""
    kw = dict(EXACT_SOLVE, lin_chunk=4, hess_chunk=3)
    want = _reference_solve(arm, jsol.vmap_safe(jsol.ILQRConfig(**kw)))
    got = tsol.device_solve(arm["tm"], arm["tcp"], tsol.ILQRConfig(**kw), T64(arm["x0"]),
                            extract_window(arm["trefs"], 0, arm["N"]), T64(arm["us"]))
    _check_solution(got, want)


# ---- H1 against the fixture ------------------------------------------------------------

@pytest.fixture(scope="module")
def h1():
    jm, cp, refs = standing_problem(jnp.float64)
    return port_model(jm), port_cost_params(cp), port_refs(refs)


@pytest.fixture(scope="module")
def fx():
    return np.load(FIXTURE)


def _window(fx):
    return ReferenceWindow(**{k: T64(fx[f"win_{k}"]) for k in
                              ("x", "u", "com", "com_vel", "ee_pos", "stance")})


@pytest.mark.parametrize("mode", ["ad", "ad_frozen_mass", "fd"])
def test_h1_linearize_matches_the_reference_fixture(h1, fx, mode):
    tm = h1[0]
    cfg = tsol.ILQRConfig(N=fx["lin_us"].shape[0], linearization=mode)
    A, B = tsol.linearize(tm, cfg, T64(fx["lin_xbar"]), T64(fx["lin_us"]))
    close(A, fx[f"lin_{mode}_A"], LIN_TOL[mode], "A")
    close(B, fx[f"lin_{mode}_B"], LIN_TOL[mode], "B")


def test_h1_rollout_matches_the_reference_fixture(h1, fx):
    """The nominal the linearizations are taken along."""
    tm = h1[0]
    xbar = tsol.rollout(tm, tsol.ILQRConfig(N=fx["lin_us"].shape[0]), T64(fx["lin_x0"]),
                        T64(fx["lin_us"]))
    close(xbar, fx["lin_xbar"], 1e-10)


def test_h1_quadraticize_exact_matches_the_reference_fixture(h1, fx):
    tm, tcp, _ = h1
    q = tquad.quadraticize(tm, tcp, _window(fx), T64(fx["cost_xs"]), T64(fx["cost_us"]))
    for name in tquad.CostQuadratics._fields:
        close(getattr(q, name), fx[f"quad_{name}"], 1e-9, name)


@pytest.mark.parametrize("mode", ["reference", "full"])
def test_h1_trajectory_cost_matches_the_reference_fixture(h1, fx, mode):
    tm, tcp, _ = h1
    got = float(tquad.trajectory_cost(tm, tcp, _window(fx), T64(fx["cost_xs"]),
                                      T64(fx["cost_us"]), mode=mode))
    want = float(fx[f"cost_{mode}"])
    assert abs(got - want) <= 1e-12 * max(1.0, abs(want))


def _stage_terms(tm, tcp, x, u, xr, ur, com, cv, ee, st):
    return dict(
        tracking=tterms.tracking_cost(tcp, x, xr, u, ur, model=tm),
        com=tterms.com_cost(tm, tcp, x, com), com_vel=tterms.com_vel_cost(tm, tcp, x, cv),
        ee_pos=tterms.ee_pos_cost(tm, tcp, x, ee, st), ee_vel=tterms.ee_vel_cost(tm, tcp, x, st),
        upright=tterms.upright_cost(tcp, x), balance=tterms.balance_cost(tm, tcp, x, ee, st),
        balance_base_vel=tterms.balance_cost(tm, tcp, x, ee, st, base_vel_approx=True),
        joint_limit=tterms.joint_limit_cost(tm, tcp, x),
        torque_limit=tterms.torque_limit_cost(tm, tcp, u),
        full=tterms.stage_cost_full(tm, tcp, x, u, xr, ur, com, cv, ee, st),
        eval_reference=tterms.stage_cost_eval(tm, tcp, x, u, xr, ur, com, cv, ee, st))


def _terminal_terms(tm, tcp, x, xr, com, cv, ee, st):
    return dict(
        tracking=tterms.tracking_cost(tcp, x, xr, terminal=True, model=tm),
        com=tterms.com_cost(tm, tcp, x, com), ee_pos=tterms.ee_pos_cost(tm, tcp, x, ee, st),
        ee_vel=tterms.ee_vel_cost(tm, tcp, x, st), upright=tterms.upright_cost(tcp, x),
        balance=tterms.balance_cost(tm, tcp, x, ee, st),
        joint_limit=tterms.joint_limit_cost(tm, tcp, x),
        full=tterms.terminal_cost_full(tm, tcp, x, xr, com, cv, ee, st),
        eval_reference=tterms.terminal_cost_eval(tm, tcp, x, xr, com, cv, ee, st))


STAGE_TERMS = ("tracking", "com", "com_vel", "ee_pos", "ee_vel", "upright", "balance",
               "balance_base_vel", "joint_limit", "torque_limit", "full", "eval_reference")
TERMINAL_TERMS = ("tracking", "com", "ee_pos", "ee_vel", "upright", "balance", "joint_limit",
                  "full", "eval_reference")


@pytest.mark.parametrize("term", [f"stage_{t}" for t in STAGE_TERMS]
                         + [f"terminal_{t}" for t in TERMINAL_TERMS])
def test_h1_cost_term_matches_the_reference_fixture(h1, fx, term):
    """Each term of stage_cost_full / terminal_cost_full on its own, at each
    knot of a window where both feet, one foot and no foot are in stance."""
    tm, tcp, _ = h1
    xs, us, win = T64(fx["cost_xs"]), T64(fx["cost_us"]), _window(fx)
    at = lambda t: (win.x[t], win.com[t], win.com_vel[t], win.ee_pos[t], win.stance[t])
    N = us.shape[0]
    if term.startswith("stage_"):
        got = [_stage_terms(tm, tcp, xs[t], us[t], win.x[t], win.u[t], *at(t)[1:])[term[6:]]
               for t in range(N)]
    else:
        got = [_terminal_terms(tm, tcp, xs[N], *at(N))[term[9:]]]
    want = np.atleast_1d(fx[term])
    got = np.array([float(g) for g in got])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    if term in ("stage_ee_pos", "stage_ee_vel", "stage_balance", "stage_com"):
        assert (want != 0.0).any()  # the term is live somewhere in the window


def test_h1_exact_mpc_steps_match_the_reference_fixture(h1, fx):
    """Two MPC steps of step_once with "ad" + "exact" (the cascade, its
    phase 1 on the plain chain) from the standing state: the carry, the
    control and the diagnostics."""
    tm, tcp, trefs = h1
    cfg = tsol.ILQRConfig(**json.loads(str(fx["mpc_cfg"])))
    assert (cfg.linearization, cfg.quad_mode) == ("ad", "exact")
    state, x = tctl.init_state(tm, cfg), standing_state(tm)
    for k in range(2):
        close(x, fx[f"mpc{k}_x"], 1e-8, f"step {k} x")
        state, u, diag = tctl.step_once(tm, tcp, cfg, trefs, state, x)
        for f in ("prev_xbar", "prev_ubar", "prev_K", "reg"):
            close(getattr(state, f), fx[f"mpc{k}_state_{f}"], 1e-8, f"step {k} {f}")
        assert state.t_idx == int(fx[f"mpc{k}_state_t_idx"])
        assert state.has_prev == bool(fx[f"mpc{k}_state_has_prev"])
        close(u, fx[f"mpc{k}_u"], 1e-8, f"step {k} u")
        assert diag.iterations == int(fx[f"mpc{k}_diag_iterations"])
        assert diag.solve_ok == bool(fx[f"mpc{k}_diag_solve_ok"]) is True
        close(diag.cost, fx[f"mpc{k}_diag_cost"], 1e-8, f"step {k} cost")
        x = engine.step(tm, x, u)


# ---- the port's own cross-checks on H1 ------------------------------------------------

@pytest.mark.parametrize("mode", ["ad", "fd", "structured", "structured_frozen_mass"])
def test_h1_lin_chunk_equals_full_width(h1, fx, mode):
    """lin_chunk 16: 70 directions (26 for the structured q-block) in groups
    that do not divide them, at tests/test_linearize_fd.py:112-136's bars."""
    tm = h1[0]
    cfg = tsol.ILQRConfig(N=fx["lin_us"].shape[0], linearization=mode)
    xs, us = T64(fx["lin_xbar"]), T64(fx["lin_us"])
    A0, B0 = tsol.linearize(tm, cfg, xs, us)
    A, B = tsol.linearize(tm, dataclasses.replace(cfg, lin_chunk=16), xs, us)
    close(A, A0.numpy(), CHUNK_TOL[mode], "A")
    close(B, B0.numpy(), CHUNK_TOL[mode], "B")


def test_h1_fd_and_frozen_mass_against_ad(h1, fx):
    """tests/test_linearize_fd.py's bars in that file's own setting
    (load_h1's contact, the standing state at gravity compensation, N=3):
    "fd" (fd_eps 1e-6) within 5e-4 of "ad"; "ad_frozen_mass" B to 1e-9 and
    A within 0.05 (the dropped dM/dq terms vanish at v = 0; at the
    fixture's moving state they reach ~0.5, in the reference too). On
    config.yaml's stiff stiction the fd gap is forward differences'
    truncation, ∝ fd_eps (the same recipe in the reference; ~4e-3 at 1e-6
    on chip_smoke's N=25 nominal): tenfold smaller fd_eps, tenfold smaller
    gap."""
    from mpc_ilqr_tpu.models.robot import load_h1

    hm = port_model(load_h1(gravity=(0, 0, -1.0), timestep=0.02, dtype=jnp.float64))
    cfg = tsol.ILQRConfig(N=3, linearization="ad")
    x0 = standing_state(hm)
    hus = engine.gravity_comp(hm, x0)[None].repeat(3, 1)
    hxs = tsol.rollout(hm, cfg, x0, hus)
    A, B = tsol.linearize(hm, cfg, hxs, hus)
    Af, Bf = tsol.linearize(hm, dataclasses.replace(cfg, linearization="fd", fd_eps=1e-6), hxs,
                            hus)
    close(Af, A.numpy(), 5e-4, "fd A")
    close(Bf, B.numpy(), 5e-4, "fd B")
    Az, Bz = tsol.linearize(hm, dataclasses.replace(cfg, linearization="ad_frozen_mass"), hxs,
                            hus)
    close(Bz, B.numpy(), 1e-9, "frozen B")
    assert float((Az - A).abs().max()) < 0.05

    tm = h1[0]
    cfg = tsol.ILQRConfig(N=fx["lin_us"].shape[0], linearization="ad")
    xs, us = T64(fx["lin_xbar"]), T64(fx["lin_us"])
    A, B = tsol.linearize(tm, cfg, xs, us)
    gap = {}
    for eps in (1e-6, 1e-7):
        Af, Bf = tsol.linearize(tm, dataclasses.replace(cfg, linearization="fd", fd_eps=eps), xs, us)
        gap[eps] = max(float((Af - A).abs().max()), float((Bf - B).abs().max()))
    assert 8.0 <= gap[1e-6] / gap[1e-7] <= 12.0, gap


def test_h1_exact_quadratics_chunked_and_against_gn(h1, fx):
    """hess_chunk 16 against full width (lxx 1e-9, lx and luu exact), and
    the GN form against the exact one (lx 1e-9, lu and luu exact):
    tests/test_costs.py:174-198 and :245-265."""
    tm, tcp, _ = h1
    win, xs, us = _window(fx), T64(fx["cost_xs"]), T64(fx["cost_us"])
    q0 = tquad.quadraticize(tm, tcp, win, xs, us)
    q = tquad.quadraticize(tm, tcp, win, xs, us, hess_chunk=16)
    close(q.lxx, q0.lxx.numpy(), 1e-9, "lxx")
    assert torch.equal(q.lx, q0.lx) and torch.equal(q.luu, q0.luu)
    g = tquad.quadraticize(tm, tcp, win, xs, us, hess_mode="gn")
    close(g.lx, q0.lx.numpy(), 1e-9, "gn lx")
    assert torch.equal(g.lu, q0.lu) and torch.equal(g.luu, q0.luu)
    gc = tquad.quadraticize(tm, tcp, win, xs, us, hess_chunk=16, hess_mode="gn")
    close(gc.lxx, g.lxx.numpy(), 1e-9, "gn chunked lxx")
    close(gc.lx, g.lx.numpy(), 1e-9, "gn chunked lx")
    assert torch.equal(gc.luu, g.luu)


def test_config_without_derivative_keys_builds_the_reference_default(tmp_path):
    """runner.setup on a config whose engine section names no linearization,
    quad_mode or cost_mode: the reference's default solver ("ad", "exact",
    "reference"), which check_config accepts."""
    from mpc_ilqr_tpu_torch.io.config import load_config
    from mpc_ilqr_tpu_torch.mpc import runner

    src = open(os.path.join(ROOT, "config.yaml")).read()
    drop = ("linearization:", "quad_mode:", "cost_mode:")
    lines = [ln for ln in src.splitlines() if not ln.strip().startswith(drop)]
    p = tmp_path / "config.yaml"
    p.write_text("\n".join(lines) + "\n")
    app = load_config(str(p))
    app.model_path = os.path.join(ROOT, app.model_path)
    for f in ("q_ref_path", "v_ref_path", "contact_schedule_path"):
        setattr(app, f, os.path.join(ROOT, getattr(app, f)))
    cfg = runner.setup(app, device="cpu").cfg
    assert (cfg.linearization, cfg.quad_mode, cfg.cost_mode) == ("ad", "exact", "reference")
    tsol.check_config(cfg)
    tsol.check_config(tsol.ILQRConfig())


# ---- float32 "fd" against the reference's own float32 "fd" ---------------------------

FD32_FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "fd32_h1.npz")
# Each float32 forward difference at fd_eps 1e-5 carries round-off of about
# eps32 / fd_eps ~ 1e-2 of the derivative, so two sum orders part further in
# "fd" than in "ad_frozen_mass". Relative cost bars: fd 2e-3 (measured gap
# 4.3e-4), ad_frozen_mass 5e-5 (measured 5.2e-6); controls 1e-3 (1.8e-4),
# states 1e-4 (1.3e-5).
FD32_COST_RTOL = {"fd": 2e-3, "ad_frozen_mass": 5e-5}


@pytest.mark.parametrize("mode", ["fd", "ad_frozen_mass"])
def test_h1_float32_fd_outcome_matches_the_reference(mode):
    """The standing flagship in float32 with cost_mode "full" and fd_eps
    1e-5 at N=6 (the shipped cascade and GN quadratics on the plain
    chains), two MPC steps from the standing state, against the JAX
    package's own run (tests/torch_fixtures/fd32_h1.npz,
    tools/port_fd32_fixture.py): the same success or failure, iterations
    and λ at every step, costs, controls and states at the float32 floor.
    The reference's "fd" fails both solves here too (iterations 3, λ
    clamped at reg_max) while "ad_frozen_mass" succeeds: in float32 at this
    fd_eps, forward differences are too noisy for the line search to
    accept a step. Not a fault of the port."""
    from mpc_ilqr_tpu_torch.io.config import load_config
    from mpc_ilqr_tpu_torch.mpc import runner

    fx = np.load(FD32_FIXTURE)
    app = load_config(os.path.join(ROOT, "config.yaml"))
    app.q_ref_path, app.v_ref_path, app.contact_schedule_path = (
        "data/q_standing.csv", "data/v_standing.csv", "data/contact_standing.csv")
    prob = runner.setup(app, device="cpu")
    cfg = dataclasses.replace(prob.cfg, linearization=mode, **json.loads(str(fx["solver"])))
    assert prob.model.dtype == torch.float32 and cfg.fd_eps == 1e-5
    state, x = tctl.init_state(prob.model, cfg), standing_state(prob.model)
    for k in range(2):
        close(x, fx[f"{mode}{k}_x"], 1e-4, f"step {k} x")
        state, u, diag = tctl.step_once(prob.model, prob.cp, cfg, prob.refs, state, x)
        assert diag.solve_ok == bool(fx[f"{mode}{k}_solve_ok"]) == (mode != "fd"), k
        assert diag.iterations == int(fx[f"{mode}{k}_iterations"]), k
        assert float(diag.reg) == float(fx[f"{mode}{k}_reg"]), k
        want = float(fx[f"{mode}{k}_cost"])
        assert abs(float(diag.cost) - want) <= FD32_COST_RTOL[mode] * abs(want), (k, diag.cost)
        close(u, fx[f"{mode}{k}_u"], 1e-3, f"step {k} u")
        x = engine.step(prob.model, x, u, cfg.n_substeps)
