"""The port's rollout entry points (K1-K3) against the JAX package's Pallas
kernels, which run here in interpret mode exactly as tests/test_ops.py and
tests/test_ops_batch.py run them. On CPU tensors the port's wrappers run
their plain PyTorch versions; float32 throughout, atol 2e-4 — the reference's
own kernel tolerance (tests/test_ops.py:165, :214). The CUDA kernels
themselves are tested in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ilqr_tpu.dynamics import engine as jeng
from mpc_ilqr_tpu.ilqr.solver import ILQRConfig, rollout
from mpc_ilqr_tpu.models.robot import load_h1, standing_state
from mpc_ilqr_tpu.ops.quat_step import build_step_plan as j_build_plan
from mpc_ilqr_tpu.ops.rollout_kernel import (
    linesearch_rollout_pallas,
    linesearch_rollout_pallas_batched,
    rollout_pallas,
)
from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk
from mpc_ilqr_tpu_torch.ops.step_plan import build_step_plan
from test_torch_common import port_model

ATOL = 2e-4
f32 = jnp.float32


@pytest.fixture(scope="module")
def h1():
    """The model of the reference kernel tests (load_h1 defaults)."""
    jm = load_h1(gravity=(0, 0, -1.0), timestep=0.02)
    tm = port_model(jm, torch.float32)
    return jm, tm, build_step_plan(tm)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _ls_inputs(jm, N, seed=0):
    """Inputs of tests/test_ops.py:181-193."""
    x0 = standing_state(jm)
    rng = np.random.default_rng(seed)
    ubar = jnp.asarray(np.asarray(jeng.gravity_comp(jm, x0))[None]
                       + 0.1 * rng.normal(0, 1, (N, jm.nu)), f32)
    xbar = rollout(jm, ILQRConfig(N=N), x0, ubar)
    K = jnp.asarray(0.01 * rng.normal(0, 1, (N, jm.nu, jm.nx)), f32)
    kff = jnp.asarray(0.1 * rng.normal(0, 1, (N, jm.nu)), f32)
    return x0, xbar, ubar, K, kff


def test_k1_rollout_matches_pallas_interpret(h1):
    jm, tm, plan = h1
    x0 = standing_state(jm)
    us = jnp.tile(jeng.gravity_comp(jm, x0)[None], (8, 1))
    want = rollout_pallas(jm, j_build_plan(jm), x0, us, interpret=True)
    got = rk.rollout_kernel(tm, plan, _t(x0), _t(us))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_k2_linesearch_matches_pallas_interpret(h1):
    jm, tm, plan = h1
    x0, xbar, ubar, K, kff = _ls_inputs(jm, 6)
    alphas = jnp.asarray(ILQRConfig().alphas, f32)
    xs_j, us_j = linesearch_rollout_pallas(jm, j_build_plan(jm), x0, xbar, ubar, K, kff,
                                           alphas, interpret=True)
    xs_t, us_t = rk.linesearch_rollout_kernel(tm, plan, *(_t(a) for a in (
        x0, xbar, ubar, K, kff, alphas)))
    assert xs_t.shape == (8, 7, jm.nx) and us_t.shape == (8, 6, jm.nu)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=0, atol=ATOL)


def test_k3_batched_linesearch_matches_pallas_interpret(h1):
    """K3 on the inputs of tests/test_ops.py:181-193 (N=6, all 8 alphas)."""
    jm, tm, plan = h1
    x0, xbar, ubar, K, kff = _ls_inputs(jm, 6)
    alphas = jnp.asarray(ILQRConfig().alphas, f32)
    xs_j, us_j = linesearch_rollout_pallas_batched(jm, j_build_plan(jm), x0, xbar, ubar, K, kff,
                                                   alphas, 1, interpret=True)
    xs_t, us_t = rk.linesearch_rollout_kernel_batched(tm, plan, *(_t(a) for a in (
        x0, xbar, ubar, K, kff, alphas)))
    assert xs_t.shape == (8, 7, jm.nx) and us_t.shape == (8, 6, jm.nu)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=0, atol=ATOL)


def test_k3_batched_linesearch_on_the_batch_tests_inputs():
    """Model and inputs of tests/test_ops_batch.py:84-102 (load_h1() as
    shipped: dt 0.002, g 9.81, feet 2 cm into the ground; N=4, 8 alphas),
    held to that test's own bar for this comparison, rtol = atol = 5e-4
    (tests/test_ops_batch.py:120-121: f32 chains through stiff contact)."""
    jm = load_h1()
    tm = port_model(jm, torch.float32)
    plan = build_step_plan(tm)
    rng = np.random.default_rng(5)
    N = 4
    x0 = jnp.asarray(np.concatenate([np.asarray(jm.key_qpos), np.zeros(jm.nv)])
                     + 0.01 * rng.standard_normal(jm.nx), f32)
    ubar = jnp.asarray(0.3 * rng.standard_normal((N, jm.nu)), f32)
    xbar = x0[None, :] + jnp.asarray(0.01 * rng.standard_normal((N + 1, jm.nx)), f32)
    K = jnp.asarray(0.05 * rng.standard_normal((N, jm.nu, jm.nx)), f32)
    kff = jnp.asarray(0.1 * rng.standard_normal((N, jm.nu)), f32)
    alphas = jnp.asarray(ILQRConfig().alphas, f32)
    xs_j, us_j = linesearch_rollout_pallas_batched(jm, j_build_plan(jm), x0, xbar, ubar, K, kff,
                                                   alphas, 1, interpret=True)
    xs_t, us_t = rk.linesearch_rollout_kernel_batched(tm, plan, *(_t(a) for a in (
        x0, xbar, ubar, K, kff, alphas)))
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=5e-4, atol=5e-4)


def test_plain_versions_agree_with_each_other(h1):
    """K2's per-alpha loop and K3's batched plain version are one function
    (float64, where only round-off separates them)."""
    jm, tm, plan = h1
    args = [torch.tensor(np.asarray(a), dtype=torch.float64) for a in _ls_inputs(jm, 5, seed=3)]
    alphas = torch.tensor([1.0, 0.4, 0.05], dtype=torch.float64)
    tm64 = tm.to(dtype=torch.float64)
    a = rk.linesearch_rollout_plain(tm64, *args, alphas)
    b = rk.linesearch_rollout_batched_plain(tm64, *args, alphas)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=1e-10)


def test_cpu_wrappers_take_the_plain_version_without_counting(h1):
    jm, tm, plan = h1
    rk.reset_launch_counts()
    x0, xbar, ubar, K, kff = (_t(a) for a in _ls_inputs(jm, 3))
    np.testing.assert_array_equal(rk.rollout_kernel(tm, plan, x0, ubar).numpy(),
                                  rk.rollout_plain(tm, x0, ubar).numpy())
    rk.linesearch_rollout_kernel_batched(tm, None, x0, xbar, ubar, K, kff, torch.ones(2))
    assert rk.LAUNCHES == {"rollout": 0, "linesearch": 0, "linesearch_batched": 0}


def test_wrappers_reject_other_devices(h1):
    jm, tm, plan = h1
    x0 = torch.zeros(jm.nx, device="meta")
    with pytest.raises(ValueError):
        rk.rollout_kernel(tm, plan, x0, torch.zeros((3, jm.nu), device="meta"))
