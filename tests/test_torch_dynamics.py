"""Port parity, float64: kinematics and the dynamics engine of
mpc_ilqr_tpu_torch against mpc_ilqr_tpu at random states of the flagship
H1 model (config.yaml contact settings), feet pressed into the ground so the
contact terms are live."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ilqr_tpu.dynamics import engine as jeng
from mpc_ilqr_tpu.dynamics import kinematics as jkin
from mpc_ilqr_tpu.models.robot import load_h1
from mpc_ilqr_tpu_torch.dynamics import engine as teng
from mpc_ilqr_tpu_torch.dynamics import kinematics as tkin
from test_torch_common import H1_KW, port_model, random_state


@pytest.fixture(scope="module")
def h1():
    jm = load_h1(dtype=jnp.float64, **H1_KW)
    return jm, port_model(jm)


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_kinematics_and_jacobians(h1, seed):
    """FK frames, per-dof axes/anchors, point and body Jacobians (1e-12)."""
    jm, tm = h1
    x, _ = random_state(jm, seed)
    q = x[: jm.nq]
    jfr = jkin.forward_kinematics(jm, jnp.asarray(q))
    tfr = tkin.forward_kinematics(tm, torch.tensor(q))
    for name, a, b in zip(jfr._fields, jfr, tfr):
        np.testing.assert_allclose(_np(b), _np(a), rtol=0, atol=1e-12, err_msg=name)
    pc_j = jkin.body_com_positions(jm, jfr)
    pc_t = tkin.body_com_positions(tm, tfr)
    np.testing.assert_allclose(_np(pc_t), _np(pc_j), rtol=0, atol=1e-12)
    for a, b in zip(jkin.body_jacobians(jm, jfr, pc_j), tkin.body_jacobians(tm, tfr, pc_t)):
        np.testing.assert_allclose(_np(b), _np(a), rtol=0, atol=1e-12)
    bidx = list(jm.cp_body_idx)
    pts = np.asarray(jfr.p)[bidx] + 0.05
    np.testing.assert_allclose(
        _np(tkin.point_jacobians(tm, tfr, bidx, torch.tensor(pts))),
        _np(jkin.point_jacobians(jm, jfr, np.asarray(bidx), jnp.asarray(pts))),
        rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_task_features_and_com(h1, seed):
    jm, tm = h1
    x, _ = random_state(jm, seed)
    for a, b in zip(jkin.task_features(jm, jnp.asarray(x)), tkin.task_features(tm, torch.tensor(x))):
        np.testing.assert_allclose(_np(b), _np(a), rtol=0, atol=1e-12)
    q, v = x[: jm.nq], x[jm.nq :]
    np.testing.assert_allclose(_np(tkin.com_velocity(tm, torch.tensor(q), torch.tensor(v))),
                               _np(jkin.com_velocity(jm, jnp.asarray(q), jnp.asarray(v))),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(tkin.ee_velocities(tm, torch.tensor(q), torch.tensor(v))),
                               _np(jkin.ee_velocities(jm, jnp.asarray(q), jnp.asarray(v))),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_mass_matrix_bias_and_gravity_comp(h1, seed):
    jm, tm = h1
    x, _ = random_state(jm, seed)
    q, v = x[: jm.nq], x[jm.nq :]
    jfr = jkin.forward_kinematics(jm, jnp.asarray(q))
    np.testing.assert_allclose(_np(teng.mass_matrix(tm, torch.tensor(q))),
                               _np(jeng.mass_matrix(jm, jfr)), rtol=0, atol=1e-11)
    np.testing.assert_allclose(_np(teng.bias_forces(tm, torch.tensor(q), torch.tensor(v))),
                               _np(jeng.bias_forces(jm, jnp.asarray(q), jnp.asarray(v))),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(_np(teng.gravity_comp(tm, torch.tensor(x))),
                               _np(jeng.gravity_comp(jm, jnp.asarray(x))), rtol=0, atol=1e-10)


@pytest.mark.parametrize("seed,n_substeps", [(0, 1), (1, 1), (2, 2)])
def test_step_matches_reference(h1, seed, n_substeps):
    """engine.step at 1e-10, the bar of tests/test_ops.py:141."""
    jm, tm = h1
    x, u = random_state(jm, seed)
    xa = jeng.step(jm, jnp.asarray(x), jnp.asarray(u), n_substeps)
    xb = teng.step(tm, torch.tensor(x), torch.tensor(u), n_substeps)
    np.testing.assert_allclose(_np(xb), _np(xa), rtol=0, atol=1e-10)


@pytest.mark.parametrize("frozen_mass", [True, False])
def test_step_and_jac_matches_reference(h1, frozen_mass):
    """(x_next, A, B) of the block-structured linearization (1e-9)."""
    jm, tm = h1
    x, u = random_state(jm, 3)
    xa, Aa, Ba = jax.jit(lambda x_, u_: jeng.step_and_jac(jm, x_, u_, frozen_mass=frozen_mass))(
        jnp.asarray(x), jnp.asarray(u))
    xb, Ab, Bb = teng.step_and_jac(tm, torch.tensor(x), torch.tensor(u), frozen_mass=frozen_mass)
    np.testing.assert_allclose(_np(xb), _np(xa), rtol=0, atol=1e-10)
    np.testing.assert_allclose(_np(Ab), _np(Aa), rtol=0, atol=1e-9)
    np.testing.assert_allclose(_np(Bb), _np(Ba), rtol=0, atol=1e-9)


# Ball and slide joints (no contact): the generality models of
# tests/test_model_generality.py, compared with the reference engine in f64.
BALL_CHAIN_XML = """<mujoco model="ballchain"><compiler angle="radian"/>
  <option timestep="0.005" gravity="0 0 -9.81"/><worldbody>
    <body name="link1" pos="0.1 -0.2 1.5" quat="0.9238795 0 0.3826834 0">
      <inertial pos="0.02 0.01 -0.25" mass="0.8" diaginertia="0.015 0.014 0.003"/>
      <joint name="b1" type="ball" pos="0 0 0.05" damping="0.02"/>
      <body name="link2" pos="0 0 -0.55" quat="0.9689124 0.2474 0 0">
        <inertial pos="0 -0.01 -0.2" mass="0.5" diaginertia="0.008 0.008 0.001"/>
        <joint name="b2" type="ball" damping="0.01"/></body></body></worldbody></mujoco>"""
MULTI_JOINT_XML = """<mujoco model="gantry"><compiler angle="radian"/>
  <option timestep="0.01" gravity="0 0 -9.81"/><worldbody>
    <body name="slider_head" pos="0.2 0.1 1.2" quat="0.9961947 0 0 0.0871557">
      <inertial pos="0.01 0 0.02" mass="1.5" diaginertia="0.02 0.018 0.012"/>
      <joint name="gx" type="slide" axis="1 0 0" damping="0.2"/>
      <joint name="gy" type="slide" axis="0 1 0" damping="0.2"/>
      <joint name="tilt" type="hinge" axis="0 1 0" pos="0 0 0.05" damping="0.05"/>
      <body name="arm" pos="0 0 -0.1">
        <inertial pos="0 0 -0.2" mass="0.4" diaginertia="0.006 0.006 0.0008"/>
        <joint name="elbow" type="hinge" axis="1 0 0" range="-1.2 1.2" damping="0.02"/>
      </body></body></worldbody>
  <actuator><motor joint="gx" gear="1"/><motor joint="tilt" gear="1"/></actuator></mujoco>"""


@pytest.mark.parametrize("xml", [BALL_CHAIN_XML, MULTI_JOINT_XML], ids=["ball", "slide"])
def test_ball_and_slide_joints_match_reference(tmp_path, xml):
    from mpc_ilqr_tpu.models.robot import load_robot

    p = tmp_path / "m.xml"
    p.write_text(xml)
    jm = load_robot(str(p), dtype=jnp.float64)
    tm = port_model(jm)
    rng = np.random.default_rng(7)
    x = rng.normal(0, 0.5, jm.nx)
    u = rng.normal(0, 2.0, jm.nu)
    jfr = jkin.forward_kinematics(jm, jnp.asarray(x[: jm.nq]))
    tfr = tkin.forward_kinematics(tm, torch.tensor(x[: jm.nq]))
    for name, a, b in zip(jfr._fields, jfr, tfr):
        np.testing.assert_allclose(_np(b), _np(a), rtol=0, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(_np(teng.step(tm, torch.tensor(x), torch.tensor(u))),
                               _np(jeng.step(jm, jnp.asarray(x), jnp.asarray(u))),
                               rtol=0, atol=1e-10)
