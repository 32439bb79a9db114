"""Port parity: robot model, config reader, CSV/reference loading, and the
packed model the CUDA kernels read (mpc_ilqr_tpu_torch vs mpc_ilqr_tpu)."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mpc_ilqr_tpu_torch.io import config as tconfig
from mpc_ilqr_tpu_torch.io import references as tref
from mpc_ilqr_tpu_torch.models import robot as trobot
from mpc_ilqr_tpu_torch.ops.step_plan import INT_HEADER, build_step_plan
from test_torch_common import H1_KW, ROOT, port_model, standing_problem

MODELS = {
    "h1": os.path.join(ROOT, "robots/h1_description/mjcf/scene.xml"),
    "h1_with_hand": os.path.join(ROOT, "robots/h1_description/mjcf/h1_with_hand.xml"),
}


@pytest.mark.parametrize("which", sorted(MODELS))
def test_robot_model_matches_reference(which):
    """Every RobotModel array of the port's loader equals the reference's
    (f64, to 1e-12) and every static field is identical."""
    from mpc_ilqr_tpu.models.robot import load_robot

    ee = ("left_ankle_link", "right_ankle_link")
    jm = load_robot(MODELS[which], ee_body_names=ee, dtype=jnp.float64, **H1_KW)
    tm = trobot.load_robot(MODELS[which], ee_body_names=ee, dtype=torch.float64,
                           device="cpu", **H1_KW)
    for f in trobot.STATIC_FIELDS:
        assert getattr(tm, f) == getattr(jm, f), f
    for f in trobot.ARRAY_FIELDS:
        a, b = np.asarray(getattr(jm, f)), getattr(tm, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12, err_msg=f)
    assert (tm.nq, tm.nv, tm.nu, tm.nx) == (jm.nq, jm.nv, jm.nu, jm.nx)


def test_h1_dims_and_standing_state():
    from mpc_ilqr_tpu.models.robot import load_h1, standing_state

    tm = trobot.load_h1(device="cpu", **H1_KW)
    assert (tm.nq, tm.nv, tm.nx, tm.nu, tm.nbody, tm.ncp) == (26, 25, 51, 19, 20, 8)
    assert tm.dtype == torch.float32 and tm.device.type == "cpu"
    np.testing.assert_array_equal(trobot.standing_state(tm).numpy(),
                                  np.asarray(standing_state(load_h1(**H1_KW))))


YAML_SNIPPET = """
# comment line
top:
  a: 3.0e4          # PyYAML reads this as a string (no sign after e)
  b: 1.0e-3
  c: [1, 'two', 3.5, "x, y"]
  d: "quoted # not a comment"
  e: yes
  f: ~
  g:
    - 1
    - 2.5
  h: .5
  empty:
flag: false
"""


@pytest.mark.parametrize("source", ["config.yaml", "snippet"])
def test_yaml_reader_matches_pyyaml(source):
    text = open(os.path.join(ROOT, "config.yaml")).read() if source == "config.yaml" else YAML_SNIPPET
    assert tconfig.parse_yaml(text) == yaml.safe_load(text)


def test_load_config_matches_reference():
    from mpc_ilqr_tpu.io.config import load_config

    a = load_config(os.path.join(ROOT, "config.yaml"))
    b = tconfig.load_config(os.path.join(ROOT, "config.yaml"))
    assert vars(a.mpc) == vars(b.mpc)
    for f in ("model_path", "urdf_path", "ee_feet", "q_ref_path", "v_ref_path",
              "contact_schedule_path", "logs_dir", "results_dir", "verbose",
              "save_trajectories", "results_path", "engine", "root"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("name", ["q_standing.csv", "v_standing.csv", "q_ref2_mj.csv",
                                  "v_ref2.npz"])
def test_csv_reader_matches_reference(name):
    from mpc_ilqr_tpu.io.references import load_csv_matrix

    path = os.path.join(ROOT, "data", name)
    np.testing.assert_allclose(tref.load_csv_matrix(path), load_csv_matrix(path),
                               rtol=0, atol=1e-12)


def test_contact_schedule_matches_reference():
    from mpc_ilqr_tpu.io.references import load_contact_schedule

    path = os.path.join(ROOT, "data", "contact_walking.csv")
    np.testing.assert_array_equal(tref.load_contact_schedule(path), load_contact_schedule(path))


def test_reference_set_matches_reference():
    """The precomputed CoM / EE tracks of the standing references (f64)."""
    jm, _, refs = standing_problem(jnp.float64)
    tm = port_model(jm)
    trefs = tref.load_reference_set(tm, *(os.path.join(ROOT, "data", f) for f in (
        "q_standing.csv", "v_standing.csv", "contact_standing.csv")), dtype=torch.float64)
    for f in ("x", "u", "com", "com_vel", "ee_pos", "ee_vel", "stance"):
        np.testing.assert_allclose(getattr(trefs, f).numpy(), np.asarray(getattr(refs, f)),
                                   rtol=0, atol=1e-12, err_msg=f)


def test_step_plan_header_mirrors_cuda_layout():
    """INT_HEADER (Python) and `enum PlanInt` (csrc/step_layout.cuh) list the
    same entries in the same order."""
    src = open(os.path.join(ROOT, "mpc_ilqr_tpu_torch/csrc/step_layout.cuh")).read()
    body = re.search(r"enum PlanInt \{(.*?)\};", src, re.S).group(1)
    names = [re.match(r"\s*PI_(\w+)", ln).group(1) for ln in body.splitlines()
             if re.match(r"\s*PI_\w+", ln)]
    assert names[-1] == "HEADER_LEN"
    assert [n.lower() for n in names[:-1]] == [n.lower() for n in INT_HEADER]


def test_step_plan_packs_the_model():
    """Every array sits at its header offset; the structure is H1's."""
    tm = trobot.load_h1(device="cpu", **H1_KW)
    plan = build_step_plan(tm)
    ib, fb = plan.ibuf.numpy(), plan.fbuf.numpy()
    hdr = dict(zip(INT_HEADER, ib[: len(INT_HEADER)]))
    assert (hdr["B"], hdr["nq"], hdr["nv"], hdr["nu"], hdr["ncp"]) == (20, 26, 25, 19, 8)
    assert (hdr["free_qpos"], hdr["free_dof"], hdr["free_body"]) == (0, 0, 0)
    B, nv = tm.nbody, tm.nv
    np.testing.assert_array_equal(ib[hdr["i_parent"]: hdr["i_parent"] + B], tm.body_parent)
    act_ptr = ib[hdr["i_act_ptr"]: hdr["i_act_ptr"] + nv + 1]
    act = ib[hdr["i_act"]: hdr["i_act"] + tm.nu]
    assert [tm.act_dof_adr[a] for a in act] == [k for k in range(nv)
                                                for _ in range(act_ptr[k], act_ptr[k + 1])]
    lev_ptr = ib[hdr["i_lev_ptr"]: hdr["i_lev_ptr"] + hdr["nlev"] + 1]
    order = ib[hdr["i_lev_body"]: hdr["i_lev_body"] + B]
    assert lev_ptr[0] == 0 and lev_ptr[-1] == B and sorted(order) == list(range(B))
    for lv in range(hdr["nlev"]):  # parents sit in earlier levels
        earlier = set(order[: lev_ptr[lv]])
        assert all(tm.body_parent[b] in earlier or tm.body_parent[b] < 0
                   for b in order[lev_ptr[lv]: lev_ptr[lv + 1]])
    for f, n in (("body_quat", 4 * B), ("dof_armature", nv), ("cp_pos", 3 * tm.ncp)):
        np.testing.assert_array_equal(fb[hdr["f_" + f]: hdr["f_" + f] + n],
                                      getattr(tm, f).numpy().reshape(-1))
    np.testing.assert_array_equal(fb[hdr["f_contact"]: hdr["f_contact"] + 4],
                                  np.float32([5000.0, 300.0, 1.0, 100.0]))
    assert hdr["f_contact"] + 4 == fb.size and plan.ibuf.dtype == torch.int32


def test_step_plan_rejects_ball_and_slide_joints(tmp_path):
    xml = tmp_path / "ball.xml"
    xml.write_text("""<mujoco><worldbody><body name="a" pos="0 0 1">
      <inertial pos="0 0 0" mass="1" diaginertia="0.1 0.1 0.1"/>
      <joint name="j" type="ball"/></body></worldbody></mujoco>""")
    m = trobot.load_robot(str(xml), device="cpu")
    with pytest.raises(NotImplementedError):
        build_step_plan(m)
