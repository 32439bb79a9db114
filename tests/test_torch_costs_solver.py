"""Port parity, float64: cost quadratics, trajectory cost, linearization,
Riccati backward pass and line search of mpc_ilqr_tpu_torch against
mpc_ilqr_tpu on the standing window of the flagship."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ilqr_tpu.costs.quadratics import CostQuadratics as JQuad
from mpc_ilqr_tpu.costs.quadratics import quadraticize, trajectory_cost
from mpc_ilqr_tpu.costs.references import extract_window
from mpc_ilqr_tpu.ilqr import solver as jsol
from mpc_ilqr_tpu_torch.costs import quadratics as tquad
from mpc_ilqr_tpu_torch.costs.references import extract_window as t_extract_window
from mpc_ilqr_tpu_torch.ilqr import solver as tsol
from test_torch_common import port_cost_params, port_model, port_refs, standing_problem

N = 5


@pytest.fixture(scope="module")
def prob():
    jm, cp, refs = standing_problem(jnp.float64)
    rng = np.random.default_rng(11)
    xs = np.zeros((N + 1, jm.nx))
    xs[:, 2], xs[:, 3] = 1.0, 1.0
    xs += 0.02 * rng.normal(size=xs.shape)
    us = rng.normal(0, 2.0, (N, jm.nu))
    tm, tcp, trefs = port_model(jm), port_cost_params(cp), port_refs(refs)
    return jm, cp, refs, tm, tcp, trefs, xs, us


@pytest.fixture(scope="module")
def nominal(prob):
    """The reference's nominal rollout at the random controls, its A/B, GN
    quadratics, backward pass and cost on the window at t=0 (one jit)."""
    jm, cp, refs, tm, tcp, trefs, xs, us = prob
    win = extract_window(refs, 0, N)
    cfg = jsol.ILQRConfig(N=N, linearization="structured_frozen_mass", quad_mode="gn")

    @jax.jit
    def ref(x0, ubar):
        xbar = jsol.rollout(jm, cfg, x0, ubar)
        A, B = jsol.linearize(jm, cfg, xbar, ubar)
        q = quadraticize(jm, cp, win, xbar, ubar, hess_mode="gn")
        K, kff = jsol.backward_pass(A, B, q, jnp.asarray(1e-6), 1e-4)
        return xbar, A, B, q, K, kff, trajectory_cost(jm, cp, win, xbar, ubar)

    out = ref(jnp.asarray(xs[0]), jnp.asarray(us))
    return jax.tree.map(np.asarray, out)


def test_quadraticize_gn_at_the_nominal(prob, nominal):
    jm, cp, refs, tm, tcp, trefs, xs, us = prob
    xbar, q = nominal[0], nominal[3]
    tq = tquad.quadraticize_gn(tm, tcp, t_extract_window(trefs, 0, N), torch.tensor(xbar),
                               torch.tensor(us))
    for name, a, b in zip(JQuad._fields, q, tq):
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-9, err_msg=name)


def test_quadraticize_gn_on_a_clamped_window(prob):
    """The window at t=196 runs past the 200-row track (rows repeat)."""
    jm, cp, refs, tm, tcp, trefs, xs, us = prob
    win, twin = extract_window(refs, 196, N), t_extract_window(trefs, 196, N)
    for f in ("x", "u", "com", "com_vel", "ee_pos", "stance"):
        np.testing.assert_array_equal(getattr(twin, f).numpy(), np.asarray(getattr(win, f)))
    q = jax.jit(lambda a, b: quadraticize(jm, cp, win, a, b, hess_mode="gn"))(
        jnp.asarray(xs), jnp.asarray(us))
    tq = tquad.quadraticize_gn(tm, tcp, twin, torch.tensor(xs), torch.tensor(us))
    for name, a, b in zip(JQuad._fields, q, tq):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-9, err_msg=name)


def test_trajectory_cost_matches_reference(prob, nominal):
    jm, cp, refs, tm, tcp, trefs, xs, us = prob
    twin = t_extract_window(trefs, 0, N)
    a = float(nominal[6])
    b = float(tquad.trajectory_cost(tm, tcp, twin, torch.tensor(nominal[0]), torch.tensor(us)))
    assert abs(a - b) <= 1e-9 * max(1.0, abs(a))
    batch = tquad.trajectory_costs(tm, tcp, twin, torch.tensor(np.stack([nominal[0], xs])),
                                   torch.tensor(np.stack([us, 0.5 * us])))
    assert abs(float(batch[0]) - a) <= 1e-9 * max(1.0, abs(a))
    assert abs(float(batch[1]) - b) > 1e-6  # a different candidate, a different cost


def test_tangent_space_tracking_cost_matches_reference(prob):
    """engine.quat_tangent: the base-orientation error as log(q_ref⁻¹ ⊗ q),
    its value, gradient and Hessian (the GN light part differentiates it)."""
    from torch.func import grad, hessian

    from mpc_ilqr_tpu.costs import terms as jterms
    from mpc_ilqr_tpu_torch.costs import terms as tterms

    jm, cp, refs, tm, tcp, trefs, xs, us = prob
    jcp = cp.replace(quat_tangent=True)
    tcp_q = dataclasses.replace(tcp, quat_tangent=True)
    x, x_ref = xs[1], np.asarray(refs.x[0])
    f_j = lambda x_: jterms.tracking_cost(jcp, x_, jnp.asarray(x_ref), model=jm)
    f_t = lambda x_: tterms.tracking_cost(tcp_q, x_, torch.tensor(x_ref), model=tm)
    assert abs(float(f_t(torch.tensor(x))) - float(f_j(jnp.asarray(x)))) <= 1e-12
    np.testing.assert_allclose(grad(f_t)(torch.tensor(x)).numpy(),
                               np.asarray(jax.grad(f_j)(jnp.asarray(x))), rtol=0, atol=1e-10)
    np.testing.assert_allclose(hessian(f_t)(torch.tensor(x)).numpy(),
                               np.asarray(jax.hessian(f_j)(jnp.asarray(x))), rtol=0, atol=1e-9)


def test_linearize_matches_reference(prob, nominal):
    """structured_frozen_mass A, B at every knot of the horizon (1e-9)."""
    jm, cp, refs, tm, tcp, trefs, xs, us = prob
    xbar, A, B = nominal[:3]
    tA, tB = tsol.linearize(tm, tsol.ILQRConfig(N=N), torch.tensor(xbar), torch.tensor(us))
    np.testing.assert_allclose(tA.numpy(), A, rtol=0, atol=1e-9)
    np.testing.assert_allclose(tB.numpy(), B, rtol=0, atol=1e-9)


@pytest.mark.parametrize("reg", [1e-6, -10.0])  # -10 forces the PD bump path
def test_backward_pass_matches_reference(reg):
    rng = np.random.default_rng(42)
    Nb, nx, nu = 10, 51, 19
    A = np.eye(nx) + 0.02 * rng.normal(size=(Nb, nx, nx))
    B = 0.02 * rng.normal(size=(Nb, nx, nu))
    lx, lu = rng.normal(size=(Nb + 1, nx)), rng.normal(size=(Nb, nu))
    lxx = np.einsum("ti,ij->tij", rng.uniform(1.0, 5.0, (Nb + 1, nx)), np.eye(nx))
    luu = np.einsum("ti,ij->tij", rng.uniform(0.1, 1.0, (Nb, nu)), np.eye(nu))
    jq = JQuad(*(jnp.asarray(a) for a in (lx, lu, lxx, luu)))
    K, k = jax.jit(lambda A_, B_: jsol.backward_pass(A_, B_, jq, jnp.asarray(reg), 1e-4))(
        jnp.asarray(A), jnp.asarray(B))
    tq = tquad.CostQuadratics(*(torch.tensor(a) for a in (lx, lu, lxx, luu)))
    tK, tk = tsol.backward_pass(torch.tensor(A), torch.tensor(B), tq, torch.tensor(reg), 1e-4)
    np.testing.assert_array_equal(np.isfinite(tK.numpy()), np.isfinite(np.asarray(K)))
    fin = np.isfinite(np.asarray(K))
    np.testing.assert_allclose(tK.numpy()[fin], np.asarray(K)[fin], rtol=0, atol=1e-9)
    np.testing.assert_allclose(tk.numpy()[np.isfinite(np.asarray(k))],
                               np.asarray(k)[np.isfinite(np.asarray(k))], rtol=0, atol=1e-9)


@pytest.mark.parametrize("mode", ["first_accept", "argmin", "cascade"])
def test_line_search_selects_like_reference(prob, nominal, mode):
    """Same accepted flag, alpha choice (trajectory) and costs, with the
    feedback law of the reference's backward pass at the nominal."""
    jm, cp, refs, tm, tcp, trefs, xs, us = prob
    xbar, K, kff, base = nominal[0], nominal[4], nominal[5], nominal[6]
    win, twin = extract_window(refs, 0, N), t_extract_window(trefs, 0, N)
    cfg_j = jsol.ILQRConfig(N=N, line_search=mode)
    ok, xs_j, us_j, c_j, best_j = jax.jit(
        lambda *a: jsol.line_search(jm, cp, cfg_j, win, *a))(
        *(jnp.asarray(a) for a in (xs[0], xbar, us, K, kff, base)))
    cfg_t = tsol.ILQRConfig(N=N, line_search=mode, rollout_backend="pallas",
                            ls_backend="pallas_batched")
    ok_t, xs_t, us_t, c_t, best_t = tsol.line_search(
        tm, tcp, cfg_t, twin, *(torch.tensor(a) for a in (xs[0], xbar, us, K, kff, base)))
    assert ok_t == bool(ok)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=0, atol=1e-9)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=0, atol=1e-9)
    assert abs(float(c_t) - float(c_j)) <= 1e-9 * max(1.0, abs(float(c_j)))
    assert abs(float(best_t) - float(best_j)) <= 1e-9 * max(1.0, abs(float(best_j)))


def test_unported_solver_options_raise():
    for field, value in (("quad_mode", "exact"), ("backward", "pallas"),
                         ("linearization", "ad"), ("cost_mode", "full")):
        with pytest.raises(NotImplementedError):
            tsol.check_config(dataclasses.replace(tsol.ILQRConfig(), **{field: value}))
