"""The port's sharded line search, sharded solve and sharded fleet step
(mpc_ilqr_tpu_torch/parallel/sharded_solve.py, parallel/sharding.py) on
spawned CPU gloo groups: 2 ranks (mesh dp=1 x ls=2) and 4 ranks (dp=2 x
ls=2), one spawn of each for the whole file (tests/torch_dist_ranks.py
holds the rank function).

Against their local counterparts on the same inputs: the sharded line
search equals `line_search` to the last bit in each mode (a cascade picks
as first_accept); `solve_sharded` equals `solve` on conftest's tiny arm and
on H1 at N=3; the gathered controls, mean cost and solve_ok count of
`shard_fleet_step` equal `fleet_step_once` over 8 arm instances, at 1e-12
(the fleet's vmapped products over 2 or 4 instances against 8). Against the
reference: the port's sharded search matches the JAX package's
`sharded_line_search` on the float32 arm (its 8-device virtual mesh, as
tests/test_sharded_solve.py:28-78) at that test's tolerances (rtol 1e-5 on
the costs, atol 1e-5 on the trajectory).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mpc_ilqr_tpu.costs.quadratics import quadraticize, trajectory_cost
from mpc_ilqr_tpu.costs.references import extract_window
from mpc_ilqr_tpu.dynamics import engine
from mpc_ilqr_tpu.ilqr import solver as jsol
from mpc_ilqr_tpu.parallel.sharded_solve import sharded_line_search as j_sharded_line_search
from mpc_ilqr_tpu_torch.costs.params import WEIGHT_FIELDS
from mpc_ilqr_tpu_torch.costs.references import TRACK_FIELDS
from mpc_ilqr_tpu_torch.ilqr import solver as tsol
from mpc_ilqr_tpu_torch.parallel import sharded_solve, sharding
from test_torch_common import model_dict
from torch_dist_ranks import spawn_group

LS_FIELDS = ("accepted", "xs", "us", "cost", "best_cost")
WINDOW_FIELDS = ("x", "u", "com", "com_vel", "ee_pos", "stance")


@pytest.fixture(scope="module")
def arm_reference(tiny_arm):
    """The arm's arrays for the ranks, and the JAX package's sharded line
    search on its 8-device mesh with its own inputs (float32, N=4)."""
    model, cp, refs = tiny_arm
    cfg = jsol.ILQRConfig(N=4)
    x0 = jnp.array([0.05, -0.05, 0.0, 0.0], jnp.float32)
    win = extract_window(refs, jnp.zeros((), jnp.int32), cfg.N)

    @jax.jit
    def inputs():
        ubar = jnp.tile(engine.gravity_comp(model, x0)[None], (cfg.N, 1))
        xbar = jsol.rollout(model, cfg, x0, ubar)
        quad = quadraticize(model, cp, win, xbar, ubar)
        A, B = jsol.linearize(model, cfg, xbar, ubar)
        K, kff = jsol.backward_pass(A, B, quad, jnp.asarray(1e-6, jnp.float32), 1e-4)
        return ubar, xbar, K, kff, trajectory_cost(model, cp, win, xbar, ubar, mode=cfg.cost_mode)

    ubar, xbar, K, kff, base = inputs()
    mesh = Mesh(np.array(jax.devices()[:8]), ("ls",))
    ls = j_sharded_line_search(mesh, model, cp, cfg)
    with mesh:
        want = jax.jit(lambda: ls(win, x0, xbar, ubar, K, kff, base))()
    cp_d = {f: np.asarray(getattr(cp, f)) for f in WEIGHT_FIELDS}
    cp_d["quat_tangent"] = cp.quat_tangent
    payload = dict(
        arm_model=model_dict(model), arm_cp=cp_d,
        arm_refs={f: np.asarray(getattr(refs, f)) for f in TRACK_FIELDS},
        arm_ls=dict(N=cfg.N, win={k: np.asarray(getattr(win, k)) for k in WINDOW_FIELDS},
                    **{k: np.asarray(v) for k, v in dict(x0=x0, xbar=xbar, ubar=ubar, K=K,
                                                         kff=kff, base=base).items()}))
    return payload, [np.asarray(w) for w in want]


@pytest.fixture(scope="module", params=[2, 4], ids=["gloo2", "gloo4"])
def group(request, arm_reference, tmp_path_factory):
    """Every rank's results of one spawned group of `world` ranks."""
    world = request.param
    ranks = spawn_group(world, arm_reference[0], str(tmp_path_factory.mktemp(f"gloo{world}")))
    return world, ranks


def _equal(a, b):
    if torch.is_tensor(a):
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_mesh_splits_like_the_reference(group):
    world, ranks = group
    want = (1, 2) if world == 2 else (2, 2)
    assert all(r["mesh_shape"] == want for r in ranks)
    assert sorted(r["coordinate"] for r in ranks) == sorted(
        (i, j) for i in range(want[0]) for j in range(want[1]))


def test_every_rank_gets_the_same_result(group):
    _, ranks = group
    shared = [k for k in ranks[0] if k not in ("coordinate", "fleet_u_mine", "fleet_block")]
    for r in ranks[1:]:
        for k in shared:
            assert _equal(r[k], ranks[0][k]), k


@pytest.mark.parametrize("mode", ["first_accept", "argmin"])
@pytest.mark.parametrize("case", ["", "_no_improvement"], ids=["improving", "no_improvement"])
def test_sharded_line_search_equals_local(group, mode, case):
    _, ranks = group
    got, want = ranks[0][f"ls_{mode}{case}"], ranks[0][f"local_{mode}{case}"]
    assert got[0] is bool(want[0]) and got[0] == (case == "")
    for name, g, w in zip(LS_FIELDS[1:], got[1:], want[1:]):
        assert torch.equal(g, w), name


def test_sharded_cascade_picks_as_first_accept(group):
    """Over one batch the cascade's two phases collapse into first_accept
    (the reference's rule): the same result to the last bit. The local
    cascade makes the same pick; its phase 1 rolls α=1 alone on another
    chain (K2's plain version), so its trajectory agrees to 1e-12."""
    _, ranks = group
    for case in ("", "_no_improvement"):
        got = ranks[0][f"ls_cascade{case}"]
        want = ranks[0][f"ls_first_accept{case}"]
        assert got[0] == want[0]
        for name, g, w in zip(LS_FIELDS[1:], got[1:], want[1:]):
            assert torch.equal(g, w), (case, name)
        want = ranks[0][f"local_cascade{case}"]
        assert got[0] == want[0]
        np.testing.assert_allclose(float(got[4]), float(want[4]), rtol=1e-12)
        if got[0]:  # a rejected search's trajectory is not used (and the phases differ there)
            for name, g, w in zip(LS_FIELDS[1:4], got[1:4], want[1:4]):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-12,
                                           err_msg=f"{case} {name}")


def test_sharded_line_search_matches_the_reference(group, arm_reference):
    _, ranks = group
    got, want = ranks[0]["ref_ls"], arm_reference[1]
    assert got[0] == bool(want[0])
    np.testing.assert_allclose(float(got[4]), float(want[4]), rtol=1e-5)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), want[2], atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), want[1], atol=1e-5)


@pytest.mark.parametrize("problem", ["arm", "h1"])
def test_solve_sharded_equals_the_local_solve(group, problem):
    """To the last bit against the local first_accept solve; on H1, whose
    config.yaml solver is the cascade, also against the local cascade,
    whose phase 1 rolls α=1 on another chain: 1e-9."""
    _, ranks = group
    got = ranks[0][f"{problem}_solve_sharded"]
    wants = {"first_accept": ranks[0][f"{problem}_solve_local"]}
    if problem == "h1":
        wants["cascade"] = ranks[0]["h1_solve_local_cascade"]
    for label, want in wants.items():
        assert (got["iterations"], got["success"], got["attempts"]) == (
            want["iterations"], want["success"], want["attempts"]), label
        assert want["success"]
        for f in ("xbar", "ubar", "K", "kff", "cost", "reg"):
            if label == "first_accept":
                assert torch.equal(got[f], want[f]), f
            else:
                np.testing.assert_allclose(got[f].numpy(), want[f].numpy(), rtol=0, atol=1e-9,
                                           err_msg=f)


def test_shard_fleet_step_equals_fleet_step_once(group):
    """tests/test_parallel.py:98-128's property: the fleet sharded over the
    mesh is a layout, not another computation."""
    world, ranks = group
    r0 = ranks[0]
    np.testing.assert_allclose(r0["fleet_u_gathered"].numpy(), r0["fleet_u_local"].numpy(),
                               rtol=0, atol=1e-12)
    for r in ranks:
        assert r["fleet_u_mine"].shape[0] == 8 // world
        np.testing.assert_allclose(r["fleet_u_mine"].numpy(), r["fleet_block"].numpy(),
                                   rtol=0, atol=1e-12)
    want_mean = float(r0["fleet_cost_local"].double().mean())
    assert abs(float(r0["fleet_mean_cost"]) - want_mean) <= 1e-12 * abs(want_mean)
    assert int(r0["fleet_n_ok"]) == int(r0["fleet_ok_local"].sum()) == 8
    assert float(r0["fleet_u_local"][:, 0].std()) > 0.0  # the instances differ


def test_sharded_functions_raise_without_a_process_group():
    """No path runs a world of one in silence: with no process group every
    entry point of both modules raises."""
    assert not torch.distributed.is_initialized()
    cfg = tsol.ILQRConfig(N=2)
    calls = {
        "make_mesh": lambda: sharding.make_mesh(1, device_type="cpu"),
        "place_fleet": lambda: sharding.place_fleet(None, torch.zeros(2)),
        "shard_fleet_step": lambda: sharding.shard_fleet_step(None, None, None, cfg, None),
        "sharded_line_search": lambda: sharded_solve.sharded_line_search(None, None, None, cfg),
        "solve_sharded": lambda: sharded_solve.solve_sharded(None, None, None, cfg, None, None,
                                                             None),
        "step_once_sharded": lambda: sharded_solve.step_once_sharded(None, None, None, cfg,
                                                                     None, None, None),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="process group"):
            call()
