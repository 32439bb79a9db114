"""The associative-scan Riccati pass (mpc_ilqr_tpu_torch/ops/assoc_riccati.py,
`backward: assoc`) against the JAX package's `backward_pass_assoc` and the
port's serial `backward_pass`, on tests/test_ops.py:52-86's inputs and at
that file's bars: float32 (N=25, 51x19) rtol 2e-3 / atol 2e-4, float64
(N=100, 12x5) rtol 1e-8 / atol 1e-9. Then the knots where Quu is not
positive definite (the bump rescues one; an indefinite luu it cannot),
and `solve` / `device_solve` with `backward: assoc` against `backward:
scan` on conftest's tiny arm and on H1 at N=4, float64: the same
iterations and success, the solution at 1e-9 (the two passes differ by
~1e-15 in K).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ilqr_tpu.costs.quadratics import CostQuadratics as JQuad
from mpc_ilqr_tpu.ops.assoc_riccati import backward_pass_assoc as j_assoc
from mpc_ilqr_tpu_torch.costs.quadratics import CostQuadratics
from mpc_ilqr_tpu_torch.costs.references import extract_window
from mpc_ilqr_tpu_torch.dynamics import engine
from mpc_ilqr_tpu_torch.ilqr import solver as tsol
from mpc_ilqr_tpu_torch.models.robot import standing_state
from mpc_ilqr_tpu_torch.ops.assoc_riccati import associative_scan, backward_pass_assoc
from test_torch_common import port_cost_params, port_model, port_refs, standing_problem

BARS = {np.float32: dict(rtol=2e-3, atol=2e-4), np.float64: dict(rtol=1e-8, atol=1e-9)}
T_BAD = 3


def riccati_inputs(N, nx, nu, dtype, seed, a_scale=0.02, lxx=(1.0, 5.0), luu=(0.1, 1.0)):
    """tests/test_ops.py:14-26 (seed 42, the float32 case) and :66-83 (seed
    1, a_scale 0.01, lxx 0.5-3, luu 0.05-1: the float64 case)."""
    rng = np.random.default_rng(seed)
    A = np.eye(nx) + a_scale * rng.normal(size=(N, nx, nx))
    B = 0.02 * rng.normal(size=(N, nx, nu))
    lx, lu = rng.normal(size=(N + 1, nx)), rng.normal(size=(N, nu))
    Lxx = np.einsum("ti,ij->tij", rng.uniform(*lxx, size=(N + 1, nx)), np.eye(nx))
    Luu = np.einsum("ti,ij->tij", rng.uniform(*luu, size=(N, nu)), np.eye(nu))
    return [a.astype(dtype) for a in (A, B, lx, lu, Lxx, Luu)]


def both(arrays, reg, pd_bump=1e-4):
    """(the port's assoc, the port's serial pass, the reference's assoc)."""
    t = [torch.as_tensor(a) for a in arrays]
    treg = torch.tensor(reg, dtype=t[0].dtype)
    got = backward_pass_assoc(t[0], t[1], CostQuadratics(*t[2:]), treg, pd_bump)
    serial = tsol.backward_pass(t[0], t[1], CostQuadratics(*t[2:]), treg, pd_bump)
    want = jax.jit(lambda A, B, *q: j_assoc(A, B, JQuad(*q), jnp.asarray(reg, A.dtype),
                                            pd_bump))(*[jnp.asarray(a) for a in arrays])
    return got, serial, [np.asarray(w) for w in want]


@pytest.mark.parametrize("case", ["float32_n25", "float64_n100"])
def test_assoc_matches_the_reference_and_the_serial_pass(case):
    if case == "float32_n25":
        arrays, reg = riccati_inputs(25, 51, 19, np.float32, 42), 1e-6
    else:
        arrays, reg = riccati_inputs(100, 12, 5, np.float64, 1, 0.01, (0.5, 3.0),
                                     (0.05, 1.0)), 1e-6
    bar = BARS[arrays[0].dtype.type]
    got, serial, want = both(arrays, reg)
    for name, g, s, w in zip(("K", "kff"), got, serial, want):
        assert g.dtype == torch.as_tensor(arrays[0]).dtype and g.shape == w.shape
        assert g.is_contiguous()  # the feedback kernels take K and kff contiguous
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"{name} vs the reference", **bar)
        np.testing.assert_allclose(g.numpy(), s.numpy(), err_msg=f"{name} vs serial", **bar)


@pytest.mark.parametrize("case", ["rescued", "indefinite"])
def test_a_knot_that_is_not_positive_definite(case):
    """float64, N=7, 13x5. "rescued": input 2 of knot t has no effect
    (B_t's column 2 is zero) and luu_t's entry -(λ + pd_bump/2), so Quu_t
    is indefinite by pd_bump/2 while luu_t + λI stays invertible; the knot
    takes the bump alone and comes out finite (k_2 = -lu_2 / (pd_bump/2)).
    From that knot on it equals the serial pass, which bumps the same knot;
    before it they part by O(pd_bump): the serial pass carries the bumped
    Quu into its value function, the scan's has no bump (the reference's
    design, mpc_ilqr_tpu/ops/assoc_riccati.py:15-17). (An exact zero
    pivot in luu_t + λI itself, which the serial pass rescues, is NaN for
    every knot up to t here and in the reference: the scan inverts
    luu + λI before it.) "indefinite": luu_t = -I, which the bump cannot
    cure; that knot alone comes out NaN, as in the reference (the scan's
    value function does not pass through Quu's factor). Nothing raises."""
    reg, bump = 2.0 ** -20, 1e-4
    arrays = riccati_inputs(7, 13, 5, np.float64, 3)
    if case == "rescued":
        arrays[1][T_BAD][:, 2] = 0.0
        arrays[5][T_BAD, 2, 2] = -(reg + bump / 2)
    else:
        arrays[5][T_BAD] = -np.eye(5)
    got, serial, want = both(arrays, reg, bump)
    for g, w in zip(got, want):
        assert np.array_equal(np.isfinite(g.numpy()), np.isfinite(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g.numpy()[fin], w[fin], **BARS[np.float64])
    bad_knots = (~torch.isfinite(got[1])).any(1).nonzero().flatten().tolist()
    if case == "rescued":
        assert bad_knots == []
        np.testing.assert_allclose(float(got[1][T_BAD, 2]), -arrays[3][T_BAD, 2] / (bump / 2),
                                   rtol=1e-9)
        for g, s in zip(got, serial):
            np.testing.assert_allclose(g[T_BAD:].numpy(), s[T_BAD:].numpy(), **BARS[np.float64])
            assert float((g[:T_BAD] - s[:T_BAD]).abs().max()) < 1e-2
    else:
        assert bad_knots == [T_BAD]


def test_associative_scan_is_an_inclusive_scan_in_both_directions():
    """Sums of prefixes and of suffixes at every length from 1 to 9 (odd and
    even lengths take the scan's two branches)."""
    for n in range(1, 10):
        x = torch.arange(1.0, n + 1.0, dtype=torch.float64)
        add = lambda a, b: (a[0] + b[0],)
        assert torch.equal(associative_scan(add, (x,))[0], x.cumsum(0))
        assert torch.equal(associative_scan(add, (x,), reverse=True)[0],
                           x.flip(0).cumsum(0).flip(0))
    # Order matters: 2x2 products compose in scan order.
    M = torch.randn(5, 2, 2, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    got = associative_scan(lambda a, b: (a[0] @ b[0],), (M,))[0]
    want = [M[0]]
    for k in range(1, 5):
        want.append(want[-1] @ M[k])
    np.testing.assert_allclose(got.numpy(), torch.stack(want).numpy(), rtol=1e-13)


def _problems(tiny_arm):
    jm, cp, refs = jax.tree.map(
        lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a, tiny_arm)
    arm = (port_model(jm), port_cost_params(cp), port_refs(refs),
           torch.tensor([0.3, -0.4, 0.5, -0.2], dtype=torch.float64))
    hm, hcp, hrefs = standing_problem(jnp.float64)
    tm = port_model(hm)
    return {"arm": arm, "h1": (tm, port_cost_params(hcp), port_refs(hrefs), standing_state(tm))}


@pytest.fixture(scope="module")
def problems(tiny_arm):
    return _problems(tiny_arm)


@pytest.mark.parametrize("solve", ["solve", "device_solve"])
@pytest.mark.parametrize("problem", ["arm", "h1"])
def test_solve_with_assoc_equals_scan(problems, problem, solve):
    m, cp, refs, x0 = problems[problem]
    N = 4
    cfg = tsol.ILQRConfig(N=N, max_iterations=3, linearization="structured_frozen_mass",
                          quad_mode="gn")
    u0 = engine.gravity_comp(m, x0)[None].repeat(N, 1)
    win = extract_window(refs, 0, N)
    fn = getattr(tsol, solve)
    want = fn(m, cp, cfg, x0, win, u0)
    got = fn(m, cp, dataclasses.replace(cfg, backward="assoc"), x0, win, u0)
    assert bool(want.success)
    for f in ("iterations", "success", "attempts"):
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    for f in ("xbar", "ubar", "K", "kff", "cost", "reg"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy(), rtol=0,
                                   atol=1e-9, err_msg=f)


def test_solve_batched_with_assoc_equals_scan(problems):
    """Under torch.func.vmap (solve_batched over 3 warm-start seeds on the
    arm): the associative pass has a batching rule for every op and gives
    the serial pass's solutions at 1e-9."""
    m, cp, refs, x0 = problems["arm"]
    N = 4
    cfg = tsol.ILQRConfig(N=N, max_iterations=3)
    g = torch.Generator().manual_seed(0)
    seeds = engine.gravity_comp(m, x0)[None, None] + torch.randn((3, N, m.nu), generator=g,
                                                                 dtype=torch.float64)
    win = extract_window(refs, 0, N)
    want = tsol.solve_batched(m, cp, cfg, x0, win, seeds)
    got = tsol.solve_batched(m, cp, dataclasses.replace(cfg, backward="assoc"), x0, win, seeds)
    assert bool(want.success.all())
    for f in ("iterations", "success", "attempts"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("xbar", "ubar", "K", "kff", "cost"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy(), rtol=0,
                                   atol=1e-9, err_msg=f)
