"""K4, the one-launch Riccati backward pass: the port's plain version (what
the wrapper runs on CPU tensors) against the JAX package's Pallas kernel in
interpret mode, float32, at that kernel's own bar (tests/test_ops.py:36-37,
rtol 2e-3 / atol 2e-4), with and without the PD bump; against the port's
`solver.backward_pass` in float64; and the wrapper's checks."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import RICCATI_REG as REG, RICCATI_T_BAD as T_BAD, riccati_problem
from mpc_ilqr_tpu.costs.quadratics import CostQuadratics as JQuad
from mpc_ilqr_tpu.ilqr import solver as jsol
from mpc_ilqr_tpu.ops.riccati import backward_pass_pallas
from mpc_ilqr_tpu_torch.costs.quadratics import CostQuadratics as TQuad
from mpc_ilqr_tpu_torch.ilqr import solver as tsol
from mpc_ilqr_tpu_torch.ops import riccati

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_problem(N, nx, nu, case="plain"):
    """chip_smoke.riccati_problem (tests/test_ops.py:14-26's inputs, with the
    bump cases) in float32."""
    return [a.astype(np.float32) for a in riccati_problem(N, nx, nu, case)]


def _assert_same(got, want, rtol, atol):
    """Non-finite exactly where the reference is, close elsewhere."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


@pytest.mark.parametrize("N,nx,nu,case", [
    (10, 51, 19, "plain"), (4, 13, 5, "plain"),  # test_ops.py:28-49's two shapes
    (10, 51, 19, "rescued"), (10, 51, 19, "indefinite"),
    (3, 64, 32, "plain"), (3, 33, 7, "plain"), (1, 51, 19, "plain"),  # the first CUDA design's
    (10, 33, 7, "rescued"), (10, 64, 32, "indefinite"),  # largest size, a ragged one, N=1,
    # and the bump at sizes other than H1's; H1 with hands (the wide design), its bump cases
    # (N=8: one step past the bad one), the first wide design's largest size, and the
    # cluster design's limit with the bump
    (3, 103, 45, "plain"), (8, 103, 45, "rescued"), (8, 103, 45, "indefinite"),
    (3, 128, 64, "plain"), (3, 160, 80, "plain"), (8, 160, 80, "rescued"),
])
def test_plain_matches_the_pallas_kernel(N, nx, nu, case):
    arrs = random_problem(N, nx, nu, case)
    K_j, k_j = backward_pass_pallas(*map(jnp.asarray, arrs), jnp.float32(REG), 1e-4,
                                    interpret=True)
    K_t, k_t = riccati.backward_pass_kernel(*map(torch.tensor, arrs), REG, 1e-4)
    assert K_t.shape == (N, nu, nx) and k_t.shape == (N, nu) and K_t.dtype == torch.float32
    _assert_same(K_t.numpy(), K_j, rtol=2e-3, atol=2e-4)
    _assert_same(k_t.numpy(), k_j, rtol=2e-3, atol=2e-4)
    if case == "rescued":  # the bump fired: k there is -lu / pd_bump, not NaN
        assert abs(float(k_t[T_BAD, 3]) + arrs[3][T_BAD, 3] / 1e-4) < 1.0
    if case == "indefinite":
        assert not np.isfinite(k_t[:T_BAD + 1].numpy()).any()
        assert np.isfinite(k_t[T_BAD + 1:].numpy()).all()


@pytest.mark.parametrize("case", ["plain", "rescued", "indefinite"])
def test_plain_matches_the_solver_loop_in_float64(case):
    """The kernel's algorithm (pivot-by-pivot Cholesky, substitution) and the
    port's torch.linalg loop compute the same function."""
    arrs = [torch.tensor(a, dtype=torch.float64) for a in random_problem(10, 51, 19, case)]
    K_p, k_p = riccati.backward_pass_plain(*arrs, REG, 1e-4)
    K_s, k_s = tsol.backward_pass(arrs[0], arrs[1], TQuad(*arrs[2:]),
                                  torch.tensor(REG, dtype=torch.float64), 1e-4)
    _assert_same(K_p.numpy(), K_s.numpy(), rtol=0, atol=1e-9)
    _assert_same(k_p.numpy(), k_s.numpy(), rtol=0, atol=1e-9)


@pytest.mark.parametrize("case,want", [("plain", []), ("rescued", [T_BAD]),
                                       ("indefinite", list(range(T_BAD, -1, -1)))])
def test_plain_reports_the_steps_where_the_bump_fires(case, want):
    """The steps chip_smoke counts a second factor at for K4's bound: none,
    the zero-pivot step, or that step and every NaN step before it."""
    arrs = [torch.tensor(a) for a in riccati_problem(10, 13, 5, case)]
    bumped = riccati.backward_pass_plain(*arrs, REG, 1e-4, with_bumps=True)[2]
    assert bumped.shape == (10,) and [t for t in range(9, -1, -1) if bumped[t]] == want


def test_solver_bump_stays_in_float64():
    """The port's solver.backward_pass against the reference's in float64
    where the bump rescues the factor: pd_bump enters in the working dtype
    (a float32 bump would move k there by ~2e-4)."""
    arrs = [a.astype(np.float64) for a in random_problem(10, 51, 19, "rescued")]
    K_j, k_j = jsol.backward_pass(*map(jnp.asarray, arrs[:2]), JQuad(*map(jnp.asarray, arrs[2:])),
                                  jnp.asarray(REG), 1e-4)
    t = [torch.tensor(a) for a in arrs]
    K_t, k_t = tsol.backward_pass(t[0], t[1], TQuad(*t[2:]), torch.tensor(REG, dtype=torch.float64),
                                  1e-4)
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), rtol=0, atol=1e-9)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=0, atol=1e-9)


def test_cpu_wrapper_runs_the_plain_version_uncounted():
    arrs = [torch.tensor(a) for a in random_problem(4, 13, 5)]
    riccati.reset_launch_counts()
    K_w, k_w = riccati.backward_pass_kernel(*arrs, torch.tensor(REG), 1e-4)
    K_p, k_p = riccati.backward_pass_plain(*arrs, REG, 1e-4)
    assert riccati.LAUNCHES == {"riccati": 0}
    assert torch.equal(K_w, K_p) and torch.equal(k_w, k_p)


def test_wrapper_raises_on_what_it_does_not_take():
    """The wrapper's checks, and its stated limit: the wide design's
    (csrc/riccati.cu kMaxNxW, kMaxNuW), at least H1 with hands and
    nx=160, nu=80 (test_torch_cuda.py holds the card to it)."""
    src = open(os.path.join(ROOT, "mpc_ilqr_tpu_torch", "csrc", "riccati.cu")).read()
    limit = tuple(int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                  for k in ("kMaxNxW", "kMaxNuW"))
    assert (riccati.MAX_NX, riccati.MAX_NU) == limit and limit >= (160, 80)
    arrs = [torch.tensor(a) for a in random_problem(4, 13, 5)]
    with pytest.raises(ValueError):  # a device that is neither CPU nor CUDA
        riccati.backward_pass_kernel(*(a.to("meta") for a in arrs), REG, 1e-4)
    with pytest.raises(ValueError):  # mixed devices
        riccati.backward_pass_kernel(arrs[0].to("meta"), *arrs[1:], REG, 1e-4)
    with pytest.raises(ValueError):  # lx one knot short
        riccati.backward_pass_kernel(arrs[0], arrs[1], arrs[2][:-1], *arrs[3:], REG, 1e-4)
    with pytest.raises(ValueError):  # B for another nx
        riccati.backward_pass_kernel(arrs[0], arrs[1][:, :-1], *arrs[2:], REG, 1e-4)
    with pytest.raises(ValueError):  # N = 0
        riccati.backward_pass_kernel(arrs[0][:0], arrs[1][:0], arrs[2][:1], arrs[3][:0],
                                     arrs[4][:1], arrs[5][:0], REG, 1e-4)



@pytest.mark.parametrize("nx,nu", [(103, 45), (160, 80), (65, 3), (128, 64)])
def test_pad_rows_pads_each_row_to_a_multiple_of_four_floats(nx, nu):
    """What the wrapper hands the wide design: every row of A, lxx, lx
    padded by zeros to ldx = round4(nx) floats, of B, luu, lu to
    ldu = round4(nu), in new contiguous tensors, the values kept."""
    arrs = [torch.tensor(a) for a in random_problem(2, nx, nu)]
    padded, ldx, ldu = riccati.pad_rows(*arrs)
    assert (ldx, ldu) == (-(-nx // 4) * 4, -(-nu // 4) * 4) and ldx % 4 == 0 and ldu % 4 == 0
    for t, p, n, ld in zip(arrs, padded, (nx, nu, nx, nu, nx, nu), (ldx, ldu, ldx, ldu, ldx, ldu)):
        assert p.shape == (*t.shape[:-1], ld) and p.is_contiguous() and p.dtype == t.dtype
        assert torch.equal(p[..., :n], t) and not bool(p[..., n:].any())
