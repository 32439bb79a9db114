"""Port parity, float64 on the CPU: the batched solves and the fleet.

ops/linalg's masked SPD solve, engine.step(solver="masked"), vmap_safe, the
device-side solve and MPC step, the tensor reference window, the
domain-randomised models, the batched seed solve and the fleet step of
mpc_ilqr_tpu_torch against mpc_ilqr_tpu, both built from the same numpy
arrays. The JAX side runs here on the tiny arm (a 2-dof arm compiles in
seconds); the H1 fleet and seed solves are held to
tests/torch_fixtures/fleet_h1.npz (tools/port_fleet_fixture.py: compiling
them takes minutes). torch.func.vmap's fallback to a per-example loop (an
op without a batching rule) is an error throughout.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ilqr_tpu.costs.references import extract_window as j_extract_window
from mpc_ilqr_tpu.dynamics import engine as jengine
from mpc_ilqr_tpu.ilqr import solver as jsol
from mpc_ilqr_tpu.ops import linalg as jlinalg
from mpc_ilqr_tpu.parallel import fleet as jfleet
from mpc_ilqr_tpu_torch import interop
from mpc_ilqr_tpu_torch.costs.references import extract_window
from mpc_ilqr_tpu_torch.dynamics import engine
from mpc_ilqr_tpu_torch.ilqr import solver as tsol
from mpc_ilqr_tpu_torch.models.robot import ARRAY_FIELDS, standing_state
from mpc_ilqr_tpu_torch.ops import linalg
from mpc_ilqr_tpu_torch.parallel import fleet
from test_torch_common import (model_dict, port_cost_params, port_model, port_refs,
                               random_state, standing_problem)

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "fleet_h1.npz")
STATE_FIELDS = fleet.STATE_FIELDS
DIAG_FIELDS = ("cost", "iterations", "reg", "solve_ok")
SHIPPED = dict(linearization="structured_frozen_mass", quad_mode="gn")  # config.yaml's
T64 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)


def spd(rng, shape, n):
    M = rng.normal(size=shape + (n, n))
    return M @ np.swapaxes(M, -1, -2) + n * np.eye(n)


# ---- ops/linalg -----------------------------------------------------------------

@pytest.mark.parametrize("batch", [(), (3, 2)], ids=["unbatched", "batched"])
@pytest.mark.parametrize("fn", ["cholesky_masked", "solve_tri_masked", "spd_solve", "spd_solve_vec"])
def test_masked_linalg_matches_reference(fn, batch):
    rng = np.random.default_rng(3)
    n, m = 7, 4
    A = spd(rng, batch, n)
    B = rng.normal(size=batch + (n, m))
    if fn == "cholesky_masked":
        args = (A,)
    elif fn == "solve_tri_masked":
        args = (np.linalg.cholesky(A), B)
    elif fn == "spd_solve":
        args = (A, B)
    else:
        fn, args = "spd_solve", (A, B[..., 0])
    want = np.asarray(getattr(jlinalg, fn)(*(jnp.asarray(a) for a in args)))
    got = getattr(linalg, fn)(*(T64(a) for a in args)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    if fn == "spd_solve":  # and it solves
        np.testing.assert_allclose(np.einsum("...ij,...j->...i", A, got) if got.ndim < A.ndim
                                   else A @ got, args[1], rtol=0, atol=1e-10)


def test_masked_spd_solve_on_an_indefinite_lhs_is_nan_where_the_reference_is():
    """A negative pivot: rsqrt gives NaN in part of the factor, not all of it
    (unlike the factored solve's all-NaN factor); the port's NaNs sit where
    the reference's do and the finite entries agree."""
    rng = np.random.default_rng(5)
    A = spd(rng, (2,), 6)
    A[0, 3, 3] = -50.0  # pivot 3 of the first matrix goes negative
    b = rng.normal(size=(2, 6))
    want = np.asarray(jlinalg.spd_solve(jnp.asarray(A), jnp.asarray(b)))
    L_want = np.asarray(jlinalg.cholesky_masked(jnp.asarray(A)))
    got = linalg.spd_solve(T64(A), T64(b)).numpy()
    L_got = linalg.cholesky_masked(T64(A)).numpy()
    for g, w in ((got, want), (L_got, L_want)):
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)], rtol=0, atol=1e-12)
    assert np.isfinite(L_got[0]).any() and not np.isfinite(L_got[0]).all()
    assert np.isfinite(got[1]).all()


# ---- engine.step(solver="masked") -------------------------------------------------

@pytest.fixture(scope="module")
def h1():
    jm, cp, refs = standing_problem(jnp.float64)
    return jm, cp, refs, port_model(jm), port_cost_params(cp), port_refs(refs)


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_step_matches_reference(h1, seed):
    jm, _, _, tm, _, _ = h1
    x, u = random_state(jm, seed)
    want = np.asarray(jax.jit(lambda a, b: jengine.step(jm, a, b, solver="masked"))(
        jnp.asarray(x), jnp.asarray(u)))
    got = engine.step(tm, T64(x), T64(u), solver="masked").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    # and the factored solve of the same step
    np.testing.assert_allclose(got, engine.step(tm, T64(x), T64(u)).numpy(), rtol=0, atol=1e-10)


def test_step_refuses_an_unknown_solver(h1):
    tm = h1[3]
    with pytest.raises(ValueError, match="solver"):
        engine.step(tm, standing_state(tm), torch.zeros(tm.nu, dtype=torch.float64),
                    solver="lu")


# ---- the solver's batched forms ----------------------------------------------------

@pytest.mark.parametrize("outer_loop", ["while", "scan"])
@pytest.mark.parametrize("line_search", ["first_accept", "argmin", "cascade"])
def test_vmap_safe_matches_reference(line_search, outer_loop):
    kw = dict(line_search=line_search, outer_loop=outer_loop, linearize_every=2)
    got, want = tsol.vmap_safe(tsol.ILQRConfig(**kw)), jsol.vmap_safe(jsol.ILQRConfig(**kw))
    for f in dataclasses.fields(tsol.ILQRConfig):
        if hasattr(want, f.name):
            assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_unported_chunking_and_kernel_backends_raise(h1):
    """lin_chunk / hess_chunk take any size >= 0 and raise on a negative
    one; the batched path keeps K4 (one launch over the batch) on the plain
    rollout chains, and device_solve refuses the rollout kernels (it takes
    no StepPlan)."""
    ok = tsol.ILQRConfig(**SHIPPED)
    for field in ("lin_chunk", "hess_chunk"):
        tsol.check_config(dataclasses.replace(ok, **{field: 8}))
        with pytest.raises(ValueError, match=f"ILQRConfig.{field} must be >= 0"):
            tsol.check_config(dataclasses.replace(ok, **{field: -1}))
    k4 = tsol.batched_config(dataclasses.replace(ok, backward="pallas", rollout_backend="pallas",
                                                 line_search="cascade"))
    assert (k4.backward, k4.rollout_backend, k4.ls_backend, k4.line_search, k4.outer_loop) == (
        "pallas", "xla", "xla", "first_accept", "scan")
    cfg = tsol.batched_config(dataclasses.replace(ok, rollout_backend="pallas",
                                                  ls_backend="pallas_batched"))
    assert (cfg.rollout_backend, cfg.ls_backend) == ("xla", "xla")
    tm = h1[3]
    x0 = standing_state(tm)
    with pytest.raises(NotImplementedError, match="plain chains"):
        tsol.device_solve(tm, None, dataclasses.replace(ok, rollout_backend="pallas", N=2),
                          x0, None, torch.zeros(2, tm.nu, dtype=torch.float64))


SOLVE_CASES = {
    "first_accept": dict(line_search="first_accept", max_iterations=3),
    "argmin_one_attempt": dict(line_search="argmin", inner_attempts=1, max_iterations=3),
    "cascade_linearize_every_2": dict(line_search="cascade", outer_loop="scan",
                                      linearize_every=2, max_iterations=3),
    # no alpha clears the bar: both attempts fail, λ ×10 each, give-up at trip 3
    "nothing_accepted": dict(line_search="first_accept", max_iterations=4,
                             accept_threshold=1e3),
}


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_device_solve_equals_solve_of_vmap_safe(h1, case):
    """At one instance the device-side solve gives what the host-side solve
    of vmap_safe(cfg) gives: the same iterations, success and attempts
    needed, the same trajectory and cost (frozen carries leave the early
    exit's result)."""
    jm, _, _, tm, tcp, trefs = h1
    cfg = tsol.ILQRConfig(N=2, tolerance=1e-3, alphas=(1.0, 0.5, 0.1, 0.02),
                          **SHIPPED, **SOLVE_CASES[case])
    x0 = standing_state(tm)
    rng = np.random.default_rng(7)
    u0 = engine.gravity_comp(tm, x0)[None] + T64(0.5 * rng.normal(size=(cfg.N, tm.nu)))
    win = extract_window(trefs, 0, cfg.N)
    want = tsol.solve(tm, tcp, tsol.vmap_safe(cfg), x0, win, u0)
    got = tsol.device_solve(tm, tcp, cfg, x0, win, u0)
    assert torch.is_tensor(got.iterations) and torch.is_tensor(got.success)
    assert int(got.iterations) == want.iterations and bool(got.success) == want.success
    assert int(got.attempts) == want.attempts  # what the early-exit form needed
    for f in ("xbar", "ubar", "K", "kff", "cost", "reg"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy(), rtol=0,
                                   atol=1e-12, err_msg=f)


@pytest.mark.parametrize("case", ["first_accept", "nothing_accepted"])
def test_device_solve_with_k4_equals_solve_of_vmap_safe(h1, case):
    """backward "pallas" (K4; its plain version on the CPU) through the
    device-side solve and the host-side solve of vmap_safe(cfg), each
    attempt with its own λ (nothing_accepted raises it ×10 twice): the bars
    of test_device_solve_equals_solve_of_vmap_safe, float64."""
    jm, _, _, tm, tcp, trefs = h1
    cfg = tsol.ILQRConfig(N=2, tolerance=1e-3, alphas=(1.0, 0.5, 0.1, 0.02), backward="pallas",
                          **SHIPPED, **SOLVE_CASES[case])
    x0 = standing_state(tm)
    rng = np.random.default_rng(7)
    u0 = engine.gravity_comp(tm, x0)[None] + T64(0.5 * rng.normal(size=(cfg.N, tm.nu)))
    win = extract_window(trefs, 0, cfg.N)
    want = tsol.solve(tm, tcp, tsol.vmap_safe(cfg), x0, win, u0)
    got = tsol.device_solve(tm, tcp, cfg, x0, win, u0)
    assert int(got.iterations) == want.iterations and bool(got.success) == want.success
    assert int(got.attempts) == want.attempts
    for f in ("xbar", "ubar", "K", "kff", "cost", "reg"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy(), rtol=0,
                                   atol=1e-12, err_msg=f)
    scan = tsol.device_solve(tm, tcp, dataclasses.replace(cfg, backward="scan"), x0, win, u0)
    np.testing.assert_allclose(got.ubar.numpy(), scan.ubar.numpy(), rtol=0, atol=1e-8)


def test_extract_window_takes_tensor_t0():
    """A 0-dim tensor t0 and a per-instance vector of them, past the track's
    end included, gather the rows the int form gathers."""
    T, N = 9, 4
    rng = np.random.default_rng(2)
    refs = interop.refs_from_numpy(dict(
        x=rng.normal(size=(T, 5)), u=rng.normal(size=(T, 2)), com=rng.normal(size=(T, 3)),
        com_vel=rng.normal(size=(T, 3)), ee_pos=rng.normal(size=(T, 2, 3)),
        ee_vel=rng.normal(size=(T, 2, 3)), stance=rng.integers(0, 2, (T, 2))),
        device="cpu", dtype=torch.float64)
    t0s = [0, 3, 6, 8, 12]
    batched = extract_window(refs, torch.tensor(t0s), N)
    for b, t0 in enumerate(t0s):
        want = extract_window(refs, t0, N)
        scalar = extract_window(refs, torch.tensor(t0), N)
        for f in ("x", "u", "com", "com_vel", "ee_pos", "stance"):
            assert torch.equal(getattr(scalar, f), getattr(want, f)), f
            assert torch.equal(getattr(batched, f)[b], getattr(want, f)), f
    assert batched.x.shape == (len(t0s), N + 1, 5) and batched.u.shape == (len(t0s), N, 2)


# ---- the domain-randomised models --------------------------------------------------

def test_randomized_models_match_reference_given_its_draws(h1):
    jm, tm = h1[0], h1[3]
    n, key = 5, jax.random.PRNGKey(4)
    k1, k2, k3 = jax.random.split(key, 3)
    mass_scale = jax.random.uniform(k1, (n,), jnp.float64, 0.8, 1.2)
    friction = jax.random.uniform(k2, (n,), jnp.float64, 0.7, 1.3)
    stiff_mult = 1.0 + 0.2 * jax.random.uniform(k3, (n,), jnp.float64, -1.0, 1.0)
    want = jfleet.randomized_models(jm, key, n)
    got = fleet.randomize(tm, T64(mass_scale), T64(friction), T64(stiff_mult))
    for f in ARRAY_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=1e-12, err_msg=f)
    drawn = fleet.randomized_models(tm, torch.Generator().manual_seed(0), n)
    ms = drawn.body_mass[:, 0] / tm.body_mass[0]
    assert drawn.body_mass.shape == (n, tm.nbody) and drawn.contact_friction.shape == (n,)
    assert bool((ms >= 0.8).all() and (ms <= 1.2).all()) and float(ms.std()) > 0.0
    assert drawn.nq == tm.nq


# ---- the tiny arm against the JAX package ----------------------------------------------

@pytest.fixture(scope="module")
def arm(tiny_arm):
    """conftest's 2-dof arm, its cost and references, cast to float64 and
    built on both sides from those arrays."""
    jm, cp, refs = jax.tree.map(
        lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a, tiny_arm)
    return jm, cp, refs, port_model(jm), port_cost_params(cp), port_refs(refs)


def test_batched_seed_solve_matches_jax_vmap_of_solve(arm):
    """3 seeds, N=4, 4 alphas, 2 iterations: solve_batched against
    jax.vmap(solve) over the same seeds."""
    jm, cp, refs, tm, tcp, trefs = arm
    kw = dict(N=4, max_iterations=2, alphas=(1.0, 0.5, 0.1, 0.02), **SHIPPED)
    x0 = np.array([0.05, -0.05, 0.0, 0.0])
    seeds = np.random.default_rng(9).normal(0.0, 2.0, (3, 4, 2))
    win = j_extract_window(refs, jnp.zeros((), jnp.int32), 4)
    cfg = jsol.ILQRConfig(**kw)
    want = jax.jit(jax.vmap(lambda u0: jsol.solve(jm, cp, cfg, jnp.asarray(x0), win, u0)))(
        jnp.asarray(seeds))
    got = tsol.solve_batched(tm, tcp, tsol.ILQRConfig(**kw), T64(x0),
                             extract_window(trefs, 0, 4), T64(seeds))
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    for f in ("xbar", "ubar", "K", "kff", "cost", "reg"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=1e-9, err_msg=f)


def _arm_fleet(arm, n=4):
    jm, cp, refs, tm, tcp, trefs = arm
    key = jax.random.PRNGKey(1)
    jmodels = jfleet.randomized_models(jm, key, n)
    models = interop.model_from_numpy(model_dict(jmodels), device="cpu", dtype=torch.float64)
    xs = np.tile(np.array([0.05, -0.05, 0.0, 0.0]), (n, 1))
    return jmodels, models, xs


def _check_step(got, want, atol):
    (s, u, d), (js, ju, jd) = got, want
    for f in STATE_FIELDS:
        np.testing.assert_allclose(getattr(s, f).numpy(), np.asarray(getattr(js, f)), rtol=0,
                                   atol=atol, err_msg=f)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=atol)
    for f in DIAG_FIELDS:
        np.testing.assert_allclose(getattr(d, f).numpy(), np.asarray(getattr(jd, f)), rtol=0,
                                   atol=atol, err_msg=f)


def test_fleet_step_once_matches_reference_on_the_arm(arm):
    """tests/test_parallel.py:71-96's fleet (4 randomised arms, N=4,
    max_iterations=2, structured_frozen_mass + gn) in float64, the models
    carried over from the reference's: the cold step from fleet_init, then
    the warm step from the reference's states, carried over."""
    jm, cp, refs, tm, tcp, trefs = arm
    n = 4
    jmodels, models, xs = _arm_fleet(arm, n)
    kw = dict(N=4, max_iterations=2, **SHIPPED)
    jcfg, cfg = jsol.ILQRConfig(**kw), tsol.ILQRConfig(**kw)
    jstep = jax.jit(lambda m, s, x: jfleet.fleet_step_once(m, cp, jcfg, refs, s, x))
    jstates = jfleet.fleet_init(jmodels, jcfg, n)
    states = fleet.fleet_init(models, cfg, n)
    for k in range(2):
        if k:  # the warm step starts from the reference's states, carried over
            states = interop.mpc_state_from_numpy(
                {f: np.asarray(getattr(jstates, f)) for f in STATE_FIELDS}, device="cpu",
                dtype=torch.float64)
        want = jstep(jmodels, jstates, jnp.asarray(xs))
        got = fleet.fleet_step_once(models, tcp, cfg, trefs, states, T64(xs))
        _check_step(got, want, 1e-9)
        assert bool(got[2].solve_ok.all())
        jstates = want[0]
    assert bool(got[0].has_prev.all()) and got[0].t_idx.tolist() == [2] * n


# The reference's K4 rounds its inputs to float32 and its gains back
# (mpc_ilqr_tpu/ops/riccati.py:156-186) whatever dtype the solve runs in;
# the port's plain version on the CPU keeps float64. Both fleets run in
# float64 and part by the float32 rounding of K and kff carried through the
# line search.
K4_FLEET_ATOL = 1e-5


def test_fleet_step_once_with_k4_matches_reference_on_the_arm(arm):
    """test_fleet_step_once_matches_reference_on_the_arm with backward
    "pallas": the port's K4 under vmap (one call over the 4 instances, each
    with its own λ) against the reference's Pallas kernel under jax.vmap in
    interpret mode (as its solve picks on the CPU), the cold and the warm
    step, float64, at K4_FLEET_ATOL; and against the port's own fleet with
    backward "scan", at the same bar."""
    jm, cp, refs, tm, tcp, trefs = arm
    n = 4
    jmodels, models, xs = _arm_fleet(arm, n)
    kw = dict(N=4, max_iterations=2, backward="pallas", **SHIPPED)
    jcfg, cfg = jsol.ILQRConfig(**kw), tsol.ILQRConfig(**kw)
    jstep = jax.jit(lambda m, s, x: jfleet.fleet_step_once(m, cp, jcfg, refs, s, x))
    jstates = jfleet.fleet_init(jmodels, jcfg, n)
    states = fleet.fleet_init(models, cfg, n)
    for k in range(2):
        if k:
            states = interop.mpc_state_from_numpy(
                {f: np.asarray(getattr(jstates, f)) for f in STATE_FIELDS}, device="cpu",
                dtype=torch.float64)
        want = jstep(jmodels, jstates, jnp.asarray(xs))
        got = fleet.fleet_step_once(models, tcp, cfg, trefs, states, T64(xs))
        _check_step(got, want, K4_FLEET_ATOL)
        assert bool(got[2].solve_ok.all())
        scan = fleet.fleet_step_once(models, tcp, dataclasses.replace(cfg, backward="scan"), trefs,
                                     states, T64(xs))
        _check_step(got, tuple(scan), K4_FLEET_ATOL)
        jstates = want[0]


def test_fleet_step_chunked_equals_fleet_step_once(arm):
    jm, cp, refs, tm, tcp, trefs = arm
    n = 4
    _, models, xs = _arm_fleet(arm, n)
    cfg = tsol.ILQRConfig(N=4, max_iterations=2, **SHIPPED)
    states = fleet.fleet_init(models, cfg, n)
    once = fleet.fleet_step_once(models, tcp, cfg, trefs, states, T64(xs))
    chunked = fleet.fleet_step_chunked(models, tcp, cfg, trefs, states, T64(xs), 2)
    _check_step(chunked, tuple(once), 1e-12)
    with pytest.raises(ValueError, match="divisible"):
        fleet.fleet_step_chunked(models, tcp, cfg, trefs, states, T64(xs), 3)


# ---- H1 against the fixture ------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture():
    return np.load(FIXTURE)


def test_h1_fleet_steps_match_the_reference_fixture(h1, fixture):
    """2 randomised H1s, N=3, one iteration, bench_suite's fleet solver with
    the masked SPD solve: the cold step and the warm step, from the JAX
    package's draws, against its fleet_step_once (tools/port_fleet_fixture.py)."""
    tm, tcp, trefs = h1[3:]
    cfg = tsol.ILQRConfig(**json.loads(str(fixture["fleet_cfg"])))
    assert cfg.rollout_solver == "masked"
    models = fleet.randomize(tm, *(T64(fixture[k]) for k in ("mass_scale", "friction",
                                                             "stiff_mult")))
    n = fixture["fleet_x"].shape[0]
    states, xs = fleet.fleet_init(models, cfg, n), T64(fixture["fleet_x"])
    for k in range(2):
        states, u, diag = fleet.fleet_step_once(models, tcp, cfg, trefs, states, xs)
        for f in STATE_FIELDS:
            np.testing.assert_allclose(getattr(states, f).numpy(), fixture[f"step{k}_state_{f}"],
                                       rtol=0, atol=1e-8, err_msg=f"step {k} {f}")
        np.testing.assert_allclose(u.numpy(), fixture[f"step{k}_u"], rtol=0, atol=1e-8)
        for f in DIAG_FIELDS:
            np.testing.assert_allclose(getattr(diag, f).numpy(), fixture[f"step{k}_diag_{f}"],
                                       rtol=0, atol=1e-8, err_msg=f"step {k} {f}")


def test_h1_batched_seed_solve_matches_the_reference_fixture(h1, fixture):
    """3 warm-start seeds on H1, N=4, 4 alphas, 2 iterations: solve_batched
    against the JAX package's jax.vmap(solve) (tools/port_fleet_fixture.py)."""
    tm, tcp, trefs = h1[3:]
    cfg = tsol.ILQRConfig(**json.loads(str(fixture["seed_cfg"])))
    got = tsol.solve_batched(tm, tcp, cfg, standing_state(tm), extract_window(trefs, 0, cfg.N),
                             T64(fixture["seeds"]))
    for f in ("iterations", "success"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), fixture[f"seeds_{f}"])
    for f in ("xbar", "ubar", "K", "kff", "cost", "reg"):
        np.testing.assert_allclose(getattr(got, f).numpy(), fixture[f"seeds_{f}"], rtol=0,
                                   atol=1e-8, err_msg=f)
