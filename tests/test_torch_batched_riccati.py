"""K4 over a batch: `torch.func.vmap` of the port's Riccati op (the custom op
`mpc_ilqr_tpu_torch::riccati_backward` and its vmap rule; on CPU tensors
the vmapped plain version) against `jax.vmap` of the JAX package's Pallas
kernel in interpret mode, float32, each instance with its own λ, at that
kernel's bar (tests/test_ops.py:36-37, rtol 2e-3 / atol 2e-4); against the
plain version one instance at a time in float64; and its launch count."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import RICCATI_REG as REG, riccati_problem
from mpc_ilqr_tpu.ops.riccati import backward_pass_pallas
from mpc_ilqr_tpu_torch.ops import riccati

PD = 1e-4
REGS = (1e-6, 1e-2)


def batch(N, nx, nu, cases, dtype):
    """riccati_problem's inputs for each case, stacked on a leading axis; the
    second instance's inputs scaled so that no two instances are equal."""
    probs = [riccati_problem(N, nx, nu, c) for c in cases]
    return [np.stack([a * (1.0 + 0.05 * i) if j < 2 else a
                      for i, a in enumerate(arrs)]).astype(dtype)
            for j, arrs in enumerate(zip(*probs))]


def _assert_same(got, want, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


def vmapped_kernel(arrs, regs, in_dims=0):
    return torch.func.vmap(lambda *a: riccati.backward_pass_kernel(*a[:6], a[6], PD),
                           in_dims=in_dims)(*arrs, regs)


@pytest.mark.parametrize("N,nx,nu,cases", [(3, 51, 19, ("plain", "plain")),
                                           (8, 13, 5, ("plain", "rescued"))])
def test_vmapped_op_matches_jax_vmap_of_the_pallas_kernel(N, nx, nu, cases):
    """Per-instance λ (1e-6, 1e-2): one batched call against jax.vmap of the
    reference kernel over A, B, the quadratics and λ. The second set puts
    the PD bump in one instance only: the bump is one decision per
    instance."""
    arrs = batch(N, nx, nu, cases, np.float32)
    regs = np.array(REGS, np.float32)
    K_j, k_j = jax.vmap(lambda *a: backward_pass_pallas(*a[:6], a[6], PD, interpret=True))(
        *map(jnp.asarray, arrs), jnp.asarray(regs))
    K_t, k_t = vmapped_kernel([torch.tensor(a) for a in arrs], torch.tensor(regs))
    assert K_t.shape == (2, N, nu, nx) and k_t.shape == (2, N, nu) and K_t.dtype == torch.float32
    _assert_same(K_t.numpy(), K_j, rtol=2e-3, atol=2e-4)
    _assert_same(k_t.numpy(), k_j, rtol=2e-3, atol=2e-4)
    # each instance at its own λ: the pair differs from the same pass at one λ
    K_one, _ = vmapped_kernel([torch.tensor(a) for a in arrs], torch.tensor(regs[:1]).expand(2))
    assert not torch.allclose(K_one[1], K_t[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("where", ["batched", "shared_reg", "batch_on_axis_1", "nested"])
def test_vmapped_op_equals_the_plain_version_per_instance(where):
    """float64: the vmap rule's batch against backward_pass_plain on each
    instance alone, with λ batched or shared, the batch on another axis,
    and under two levels of vmap."""
    arrs = [torch.tensor(a) for a in batch(8, 13, 5, ("plain", "rescued"), np.float64)]
    regs = torch.tensor((REG, 1e-2), dtype=torch.float64)
    if where == "shared_reg":
        regs = regs[:1].expand(2)
        K, k = torch.func.vmap(lambda *a: riccati.backward_pass_kernel(*a, regs[0], PD))(*arrs)
    elif where == "batch_on_axis_1":
        K, k = vmapped_kernel([a.movedim(0, 1) for a in arrs], regs, in_dims=(1,) * 6 + (0,))
    elif where == "nested":
        two = [torch.stack([a, a]) for a in arrs]
        K, k = torch.func.vmap(lambda *a: vmapped_kernel(a[:6], a[6]))(*two, torch.stack([regs,
                                                                                         regs]))
        assert K.shape[:2] == (2, 2) and torch.equal(K[0], K[1]) and torch.equal(k[0], k[1])
        K, k = K[0], k[0]
    else:
        K, k = vmapped_kernel(arrs, regs)
    for i in range(2):
        K_p, k_p = riccati.backward_pass_plain(*(a[i] for a in arrs), regs[i], PD)
        _assert_same(K[i].numpy(), K_p.numpy(), rtol=0, atol=1e-12)
        _assert_same(k[i].numpy(), k_p.numpy(), rtol=0, atol=1e-12)


def test_vmapped_op_on_the_cpu_counts_no_launch():
    arrs = [torch.tensor(a) for a in batch(3, 13, 5, ("plain", "plain"), np.float32)]
    riccati.reset_launch_counts()
    vmapped_kernel(arrs, torch.tensor(REGS))
    riccati.riccati_backward(*(a.contiguous() for a in arrs), torch.tensor(REGS), PD)
    assert riccati.LAUNCHES == {"riccati": 0}
