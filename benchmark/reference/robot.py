"""[Frozen copy of mpc_ilqr_tpu_torch/models/robot.py, lines 1-374, with its
imports made relative; the loader and the standing state, without the
program's H1 shortcut and its mass and gravity knobs.]

Robot model as a dataclass of tensors, built from MJCF.

Same fields as the reference model: the static structure (tree topology,
dof layout, joint types) stays plain Python tuples so the kinematics unroll
over it, and every per-body quantity is a stacked tensor on one device and
dtype (`load_robot(..., device=, dtype=)`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import mjcf as mjcf_mod
from . import stl
from ._np_quat import np_quat_to_mat

JNT_FREE = "free"
JNT_BALL = "ball"
JNT_HINGE = "hinge"
JNT_SLIDE = "slide"
JNT_FIXED = "fixed"

# (nq, nv) consumed per joint type
JNT_SIZES = {JNT_FREE: (7, 6), JNT_BALL: (4, 3), JNT_HINGE: (1, 1), JNT_SLIDE: (1, 1)}

STATIC_FIELDS = (
    "name", "nq", "nv", "nu", "nbody", "body_names", "body_parent", "body_jnt_type",
    "body_qpos_adr", "body_dof_adr", "joint_names", "act_dof_adr", "ee_body_idx",
    "cp_body_idx", "limit_qpos_idx", "timestep",
)
ARRAY_FIELDS = (
    "body_pos", "body_quat", "body_ipos", "body_iquat", "body_mass", "body_inertia",
    "jnt_axis", "jnt_pos", "dof_damping", "dof_armature", "ancestor_mask", "act_gear",
    "ctrl_range", "limit_range", "gravity", "cp_pos", "cp_radius", "contact_stiffness",
    "contact_damping", "contact_friction", "contact_impratio", "key_qpos",
)


@dataclasses.dataclass(frozen=True, eq=False)
class RobotModel:
    # --- static structure ---
    name: str
    nq: int
    nv: int
    nu: int
    nbody: int
    body_names: Tuple[str, ...]
    body_parent: Tuple[int, ...]
    body_jnt_type: Tuple[str, ...]
    body_qpos_adr: Tuple[int, ...]
    body_dof_adr: Tuple[int, ...]
    joint_names: Tuple[str, ...]  # per body ("" if fixed)
    act_dof_adr: Tuple[int, ...]  # dof index per actuator
    ee_body_idx: Tuple[int, ...]  # end-effector bodies
    cp_body_idx: Tuple[int, ...]  # contact-point bodies
    limit_qpos_idx: Tuple[int, ...]  # limited hinge qpos
    timestep: float

    # --- tensors ---
    body_pos: torch.Tensor  # (B, 3) frame offset in parent frame
    body_quat: torch.Tensor  # (B, 4) wxyz
    body_ipos: torch.Tensor  # (B, 3) inertial frame origin in body frame
    body_iquat: torch.Tensor  # (B, 4)
    body_mass: torch.Tensor  # (B,)
    body_inertia: torch.Tensor  # (B, 3) diagonal inertia in inertial frame
    jnt_axis: torch.Tensor  # (B, 3) hinge axis in body frame (unused rows = z)
    jnt_pos: torch.Tensor  # (B, 3) hinge anchor in body frame
    dof_damping: torch.Tensor  # (nv,)
    dof_armature: torch.Tensor  # (nv,)
    ancestor_mask: torch.Tensor  # (B, nv) 1.0 where dof k moves body b
    act_gear: torch.Tensor  # (nu,)
    ctrl_range: torch.Tensor  # (nu, 2)
    limit_range: torch.Tensor  # (n_limited, 2) hinge joint limits
    gravity: torch.Tensor  # (3,)
    cp_pos: torch.Tensor  # (ncp, 3) contact points in body frame
    cp_radius: torch.Tensor  # (ncp,) surface radius: depth = radius - z_world
    contact_stiffness: torch.Tensor  # () N/m normal spring
    contact_damping: torch.Tensor  # () N·s/m normal damper
    contact_friction: torch.Tensor  # () Coulomb mu (smoothed)
    contact_impratio: torch.Tensor  # () frictional-to-normal impedance ratio
    key_qpos: torch.Tensor  # (nq,) "home" keyframe (zeros if absent)

    @property
    def nx(self) -> int:
        return self.nq + self.nv

    @property
    def ncp(self) -> int:
        return len(self.cp_body_idx)

    @property
    def has_free_base(self) -> bool:
        return JNT_FREE in self.body_jnt_type

    @property
    def n_ee(self) -> int:
        return len(self.ee_body_idx)

    @property
    def dtype(self) -> torch.dtype:
        return self.body_pos.dtype

    @property
    def device(self) -> torch.device:
        return self.body_pos.device

    def replace(self, **kw) -> "RobotModel":
        return dataclasses.replace(self, **kw)

    def to(self, device=None, dtype=None) -> "RobotModel":
        return self.replace(**{
            f: getattr(self, f).to(device=device, dtype=dtype) for f in ARRAY_FIELDS
        })

    def split_state(self, x: torch.Tensor):
        return x[..., : self.nq], x[..., self.nq :]


@functools.lru_cache(maxsize=None)
def _static(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def static_tensor(values, device, dtype=torch.long) -> torch.Tensor:
    """A model's static index list (or other constant tuple) as a tensor on
    `device`, made once per process. Indexing a CUDA tensor with a Python
    list copies the list to the card and waits for the copy on every call."""
    return _static(tuple(values), dtype, torch.device(device))


def load_robot(
    xml_path: str,
    ee_body_names: Tuple[str, ...] = (),
    contact_stiffness: float = 3.0e4,
    contact_damping: float = 3.0e3,
    contact_friction: float = 1.0,
    contact_impratio: float = 1.0,
    gravity: Optional[Tuple[float, float, float]] = None,
    timestep: Optional[float] = None,
    dtype=torch.float32,
    device="cuda",
) -> RobotModel:
    """Parse an MJCF file into a RobotModel on `device`.

    Free/ball/hinge/slide joints; a body with several joints becomes a chain
    of massless intermediate bodies (one joint each); contact points come
    from collision meshes or primitive geoms on the end-effector bodies.
    """
    spec = mjcf_mod.parse_mjcf(xml_path)

    # --- split multi-joint bodies into single-joint chains ---
    bodies = []
    new_index = {}  # spec index -> chain-tail index in `bodies`
    for old_i, b in enumerate(spec.bodies):
        parent_new = new_index[b.parent] if b.parent >= 0 else -1
        if len(b.joints) <= 1:
            bodies.append(mjcf_mod.BodySpec(
                name=b.name, parent=parent_new, pos=b.pos, quat=b.quat,
                ipos=b.ipos, iquat=b.iquat, mass=b.mass, inertia=b.inertia,
                joints=list(b.joints), geoms=list(b.geoms),
            ))
            new_index[old_i] = len(bodies) - 1
            continue
        for m, j in enumerate(b.joints):
            last = m == len(b.joints) - 1
            bodies.append(mjcf_mod.BodySpec(
                name=b.name if last else f"{b.name}__chain{m}",
                parent=parent_new,
                pos=b.pos if m == 0 else np.zeros(3),
                quat=b.quat if m == 0 else np.array([1.0, 0, 0, 0]),
                ipos=b.ipos if last else np.zeros(3),
                iquat=b.iquat if last else np.array([1.0, 0, 0, 0]),
                mass=b.mass if last else 0.0,
                inertia=b.inertia if last else np.zeros(3),
                joints=[j],
                geoms=list(b.geoms) if last else [],
            ))
            parent_new = len(bodies) - 1
        new_index[old_i] = parent_new
    B = len(bodies)

    body_parent, body_jnt_type, body_qpos_adr, body_dof_adr, joint_names = [], [], [], [], []
    jnt_axis = np.tile(np.array([0.0, 0, 1.0]), (B, 1))
    jnt_pos = np.zeros((B, 3))
    limit_qpos_idx, limit_range = [], []
    nq = nv = 0
    dof_damping, dof_armature = [], []
    for i, b in enumerate(bodies):
        body_parent.append(b.parent)
        if not b.joints:
            body_jnt_type.append(JNT_FIXED)
            body_qpos_adr.append(-1)
            body_dof_adr.append(-1)
            joint_names.append("")
            continue
        j = b.joints[0]
        if j.jtype not in JNT_SIZES:
            raise NotImplementedError(f"joint type {j.jtype}")
        joint_names.append(j.name)
        body_qpos_adr.append(nq)
        body_dof_adr.append(nv)
        body_jnt_type.append(j.jtype)
        dnq, dnv = JNT_SIZES[j.jtype]
        if j.jtype in (JNT_HINGE, JNT_SLIDE):
            jnt_axis[i] = j.axis / np.linalg.norm(j.axis)
            jnt_pos[i] = j.pos
            if np.all(np.isfinite(j.range)) and j.range[0] < j.range[1]:
                limit_qpos_idx.append(nq)
                limit_range.append(j.range)
        elif j.jtype == JNT_BALL:
            jnt_pos[i] = j.pos
        nq += dnq
        nv += dnv
        dof_damping += [j.damping] * dnv
        dof_armature += [j.armature] * dnv

    # Ancestor mask: dof k moves body b iff k's joint is on b or an ancestor.
    ancestor = np.zeros((B, nv))
    for i in range(B):
        c = i
        while c >= 0:
            if body_jnt_type[c] != JNT_FIXED:
                dnv = JNT_SIZES[body_jnt_type[c]][1]
                ancestor[i, body_dof_adr[c] : body_dof_adr[c] + dnv] = 1.0
            c = body_parent[c]

    # Actuators (motors on hinge/slide joints; torque tau = gear * u).
    act_dof_adr, act_gear, ctrl_range = [], [], []
    jn_to_body = {jn: i for i, jn in enumerate(joint_names) if jn}
    for a in spec.actuators:
        bidx = jn_to_body[a.joint]
        if body_jnt_type[bidx] not in (JNT_HINGE, JNT_SLIDE):
            raise NotImplementedError(
                f"actuator on {body_jnt_type[bidx]} joint {a.joint!r}; "
                "motors are supported on hinge/slide joints"
            )
        act_dof_adr.append(body_dof_adr[bidx])
        act_gear.append(a.gear)
        ctrl_range.append(a.ctrlrange)
    nu = len(act_dof_adr)

    # End-effectors and contact points.
    name_to_idx = {b.name: i for i, b in enumerate(bodies)}
    ee_body_idx = tuple(name_to_idx[n] for n in ee_body_names)
    cp_body_idx, cp_pos, cp_radius = [], [], []

    def add_point(bidx, p, r=0.0):
        cp_body_idx.append(bidx)
        cp_pos.append(np.asarray(p, dtype=np.float64))
        cp_radius.append(float(r))

    for bidx in ee_body_idx:
        for g in bodies[bidx].geoms:
            if not (g.contype or g.conaffinity):
                continue
            if g.mesh and g.mesh in spec.meshes:
                # Collision mesh: sampled sole vertices ARE the surface.
                verts = stl.read_stl_vertices(spec.meshes[g.mesh])
                verts = (np_quat_to_mat(g.quat) @ verts.T).T + g.pos
                for p in stl.sole_contact_points(verts):
                    add_point(bidx, p)
                break
            # Primitive geoms: centers/corners, surface radius in cp_radius.
            Rg = np_quat_to_mat(g.quat)
            if g.gtype == "sphere":
                add_point(bidx, g.pos, g.size[0])
                break
            if g.gtype == "capsule":
                half = g.size[1] if g.size.size > 1 else 0.0
                for s in (-half, half):
                    add_point(bidx, g.pos + Rg @ np.array([0.0, 0, s]), g.size[0])
                break
            if g.gtype == "box":
                sx, sy, sz = g.size[:3]
                for cx in (-sx, sx):
                    for cy in (-sy, sy):
                        for cz in (-sz, sz):
                            add_point(bidx, g.pos + Rg @ np.array([cx, cy, cz]))
                break

    key_qpos = np.zeros(nq)
    if "home" in spec.keyframes:
        key_qpos = spec.keyframes["home"]
    elif spec.keyframes:
        key_qpos = next(iter(spec.keyframes.values()))

    g = np.array(gravity) if gravity is not None else spec.gravity
    arr = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

    return RobotModel(
        name=spec.model_name,
        nq=nq,
        nv=nv,
        nu=nu,
        nbody=B,
        body_names=tuple(b.name for b in bodies),
        body_parent=tuple(body_parent),
        body_jnt_type=tuple(body_jnt_type),
        body_qpos_adr=tuple(body_qpos_adr),
        body_dof_adr=tuple(body_dof_adr),
        joint_names=tuple(joint_names),
        act_dof_adr=tuple(act_dof_adr),
        ee_body_idx=ee_body_idx,
        cp_body_idx=tuple(cp_body_idx),
        limit_qpos_idx=tuple(limit_qpos_idx),
        timestep=float(timestep if timestep is not None else spec.timestep),
        body_pos=arr(np.stack([b.pos for b in bodies])),
        body_quat=arr(np.stack([b.quat for b in bodies])),
        body_ipos=arr(np.stack([b.ipos for b in bodies])),
        body_iquat=arr(np.stack([b.iquat for b in bodies])),
        body_mass=arr([b.mass for b in bodies]),
        body_inertia=arr(np.stack([b.inertia for b in bodies])),
        jnt_axis=arr(jnt_axis),
        jnt_pos=arr(jnt_pos),
        dof_damping=arr(dof_damping),
        dof_armature=arr(dof_armature),
        ancestor_mask=arr(ancestor),
        act_gear=arr(act_gear),
        ctrl_range=arr(np.stack(ctrl_range) if ctrl_range else np.zeros((0, 2))),
        limit_range=arr(np.stack(limit_range) if limit_range else np.zeros((0, 2))),
        gravity=arr(g),
        cp_pos=arr(np.array(cp_pos).reshape(-1, 3)),
        cp_radius=arr(np.array(cp_radius).reshape(-1)),
        contact_stiffness=arr(contact_stiffness),
        contact_damping=arr(contact_damping),
        contact_friction=arr(contact_friction),
        contact_impratio=arr(contact_impratio),
        key_qpos=arr(key_qpos),
    )


def standing_state(model: RobotModel, height: float = 1.0432) -> torch.Tensor:
    """Standing initial state: zeros except base z and qw."""
    x = torch.zeros(model.nx, dtype=model.dtype, device=model.device)
    x[2] = height
    x[3] = 1.0
    return x
