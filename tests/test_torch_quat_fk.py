"""The quaternion / one-hot forward kinematics (mpc_ilqr_tpu_torch/ops/quat_fk.py)
against the JAX package's `quat_frames` and against the port's matrix FK
(`dynamics.kinematics.forward_kinematics`), on H1 and H1 with hands,
float64, at a random configuration (tests/test_ops.py:89-117's recipe).

Against the reference's quat_frames: atol 1e-12 (the same one-hot products
and quaternion algebra; they agree to ~1e-16). Against the matrix FK: the
reference test's own bar, assert_allclose's atol 1e-12 with its default
rtol 1e-7 (R from the quaternions differs from the composed matrices by up
to 2e-12 on h1_with_hand, in the reference too).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ilqr_tpu.models.robot import load_h1, load_robot
from mpc_ilqr_tpu.ops.quat_fk import build_level_plans as j_build_level_plans
from mpc_ilqr_tpu.ops.quat_fk import quat_frames as j_quat_frames
from mpc_ilqr_tpu_torch.dynamics import math as qm
from mpc_ilqr_tpu_torch.dynamics.kinematics import forward_kinematics
from mpc_ilqr_tpu_torch.ops.quat_fk import build_level_plans, quat_frames
from test_torch_common import ROOT, port_model

MODELS = {"h1": lambda: load_h1(dtype=jnp.float64),
          "h1_with_hand": lambda: load_robot(
              os.path.join(ROOT, "robots/h1_description/mjcf/h1_with_hand.xml"),
              dtype=jnp.float64)}


def random_q(nq, rng):
    q = np.zeros(nq)
    q[:3] = rng.normal(size=3)
    quat = rng.normal(size=4)
    q[3:7] = quat / np.linalg.norm(quat)
    q[7:] = rng.normal(0, 0.5, nq - 7)
    return q


@pytest.mark.parametrize("name", list(MODELS))
def test_quat_frames_match_the_reference_and_the_matrix_fk(name):
    jm = MODELS[name]()
    tm = port_model(jm)
    rng = np.random.default_rng(11)
    for _ in range(3):
        q = random_q(jm.nq, rng)
        JQ, JP = j_quat_frames(jm, j_build_level_plans(jm), jnp.asarray(q))
        plans = build_level_plans(tm)
        Q, P = quat_frames(tm, plans, torch.tensor(q))
        assert Q.shape == (tm.nbody, 4) and P.shape == (tm.nbody, 3)
        np.testing.assert_allclose(Q.numpy(), np.asarray(JQ), rtol=0, atol=1e-12)
        np.testing.assert_allclose(P.numpy(), np.asarray(JP), rtol=0, atol=1e-12)
        fr = forward_kinematics(tm, torch.tensor(q))
        np.testing.assert_allclose(P.numpy(), fr.p.numpy(), atol=1e-12)
        np.testing.assert_allclose(qm.quat_to_mat(Q).numpy(), fr.R.numpy(), atol=1e-12)


def test_level_plans_place_every_body_once():
    """Each body is scattered by exactly one plan; hinge plans select one
    coordinate per body; a ball joint is refused, as in the reference."""
    tm = port_model(load_h1(dtype=jnp.float64))
    plans = build_level_plans(tm)
    placed = sorted(i for p in plans for i in p.body_idx)
    assert placed == list(range(tm.nbody))
    total = torch.cat([p.scatter_child for p in plans], dim=1).sum(1)
    assert torch.equal(total, torch.ones(tm.nbody, dtype=torch.float64))
    for p in plans:
        if p.kind == "hinge":
            assert torch.equal(p.qsel.sum(1), torch.ones(len(p.body_idx), dtype=torch.float64))
    ball = tm.replace(body_jnt_type=tuple("ball" if t == "hinge" else t
                                          for t in tm.body_jnt_type))
    with pytest.raises(NotImplementedError, match="free/hinge/fixed"):
        build_level_plans(ball)
