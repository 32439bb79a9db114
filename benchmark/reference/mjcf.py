"""[Frozen copy of mpc_ilqr_tpu_torch/models/mjcf.py, lines 1-339, with its imports made relative.]

Standalone MJCF parser → plain-python robot specification.

Replaces the reference's dependence on ``mj_loadXML`` (robot_utils.cpp:19-55)
and the parallel Pinocchio URDF model (derivatives.cpp:26-59) with a single
parser feeding one tensor model. Only the subset of MJCF needed for rigid-body
MPC is handled: kinematic tree, inertials, free/ball/hinge/slide joints
(multiple joints per body supported — split into a chain downstream in
models/robot.py), motors, meshes and primitive geoms (for contact-point
extraction), degree/radian angle modes with euler frame attributes,
options, and keyframes.

No MuJoCo dependency — `xml.etree` + numpy only, so the framework stands
alone. The test-suite cross-validates the parsed arrays against the mujoco
python bindings when they are available.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


def _floats(s: str) -> np.ndarray:
    return np.array([float(v) for v in s.replace(",", " ").split()], dtype=np.float64)


@dataclass
class JointSpec:
    name: str
    jtype: str  # "free" | "ball" | "hinge" | "slide"
    pos: np.ndarray
    axis: np.ndarray
    range: np.ndarray  # (2,), ±inf if unlimited
    damping: float
    armature: float


@dataclass
class GeomSpec:
    name: str
    gtype: str
    mesh: Optional[str]
    size: np.ndarray
    pos: np.ndarray
    quat: np.ndarray
    contype: int
    conaffinity: int


@dataclass
class BodySpec:
    name: str
    parent: int  # index into bodies list, -1 = world
    pos: np.ndarray
    quat: np.ndarray
    ipos: np.ndarray
    iquat: np.ndarray
    mass: float
    inertia: np.ndarray  # (3,) diagonal in inertial frame
    joints: List[JointSpec] = field(default_factory=list)
    geoms: List[GeomSpec] = field(default_factory=list)


@dataclass
class ActuatorSpec:
    name: str
    joint: str
    gear: float
    ctrlrange: np.ndarray


@dataclass
class MJCFSpec:
    model_name: str
    bodies: List[BodySpec]
    actuators: List[ActuatorSpec]
    meshes: Dict[str, str]  # mesh name -> absolute file path
    gravity: np.ndarray
    timestep: float
    keyframes: Dict[str, np.ndarray]

    def body_index(self, name: str) -> int:
        for i, b in enumerate(self.bodies):
            if b.name == name:
                return i
        raise KeyError(name)


class _Defaults:
    """Resolves MJCF default-class attribute inheritance."""

    def __init__(self):
        # class name -> element tag -> {attr: value}
        self.table: Dict[str, Dict[str, Dict[str, str]]] = {"": {}}
        self.parent: Dict[str, str] = {}

    def add_tree(self, node: ET.Element, parent_cls: str = ""):
        cls = node.get("class", parent_cls if node.tag == "default" else "")
        if node.tag == "default":
            cls = node.get("class", "")
            self.table.setdefault(cls, {})
            self.parent[cls] = parent_cls
            for child in node:
                if child.tag == "default":
                    self.add_tree(child, cls)
                else:
                    d = self.table[cls].setdefault(child.tag, {})
                    d.update(child.attrib)

    def resolve(self, tag: str, explicit: Dict[str, str], cls: str) -> Dict[str, str]:
        chain = []
        c = cls
        seen = set()
        while c in self.table and c not in seen:
            seen.add(c)
            chain.append(c)
            c = self.parent.get(c, "")
            if c == "" and "" not in self.table:
                break
        merged: Dict[str, str] = {}
        for c in reversed(chain):
            merged.update(self.table.get(c, {}).get(tag, {}))
        merged.update(explicit)
        return merged


def _merge_includes(path: str) -> ET.Element:
    tree = ET.parse(path)
    root = tree.getroot()
    base = os.path.dirname(os.path.abspath(path))
    _expand_includes(root, base)
    return root


def _expand_includes(node: ET.Element, base: str):
    i = 0
    while i < len(node):
        child = node[i]
        if child.tag == "include":
            inc_path = os.path.join(base, child.get("file"))
            inc_root = _merge_includes(inc_path)
            node.remove(child)
            # Splice the included file's children in place. MuJoCo merges
            # same-named sections; element order within sections is preserved.
            for j, sub in enumerate(list(inc_root)):
                node.insert(i + j, sub)
        else:
            _expand_includes(child, base)
            i += 1


def parse_mjcf(path: str) -> MJCFSpec:
    root = _merge_includes(path)
    base = os.path.dirname(os.path.abspath(path))

    # compiler (MJCF defaults: angle="degree", eulerseq="xyz")
    meshdir = ""
    degrees = True
    eulerseq = "xyz"
    for comp in root.iter("compiler"):
        meshdir = comp.get("meshdir", meshdir)
        degrees = comp.get("angle", "degree" if degrees else "radian") == "degree"
        eulerseq = comp.get("eulerseq", eulerseq)
    mesh_base = os.path.normpath(os.path.join(base, meshdir)) if meshdir else base

    def to_rad(a: np.ndarray) -> np.ndarray:
        return np.deg2rad(a) if degrees else a

    def frame_quat(attrs: Dict[str, str]) -> np.ndarray:
        """Orientation of a body/geom frame from quat or euler attributes."""
        if attrs.get("euler") is not None:
            from ._np_quat import np_euler_to_quat

            return np_euler_to_quat(to_rad(_floats(attrs["euler"])), eulerseq)
        return _floats(attrs.get("quat", "1 0 0 0"))

    defaults = _Defaults()
    for dnode in root.findall("default"):
        defaults.add_tree(dnode)

    # options
    gravity = np.array([0.0, 0.0, -9.81])
    timestep = 0.002
    for opt in root.findall("option"):
        if opt.get("gravity"):
            gravity = _floats(opt.get("gravity"))
        if opt.get("timestep"):
            timestep = float(opt.get("timestep"))

    # assets
    meshes: Dict[str, str] = {}
    for asset in root.findall("asset"):
        for m in asset.findall("mesh"):
            fname = m.get("file")
            name = m.get("name") or os.path.splitext(os.path.basename(fname))[0]
            meshes[name] = os.path.join(mesh_base, fname)

    bodies: List[BodySpec] = []

    def parse_body(node: ET.Element, parent: int, childclass: str):
        cls = node.get("childclass", childclass)
        battrs = node.attrib
        pos = _floats(battrs.get("pos", "0 0 0"))
        quat = frame_quat(battrs)

        inertial = node.find("inertial")
        if inertial is not None:
            ipos = _floats(inertial.get("pos", "0 0 0"))
            iquat = frame_quat(inertial.attrib)
            mass = float(inertial.get("mass", "0"))
            if inertial.get("diaginertia") is not None:
                inertia = _floats(inertial.get("diaginertia"))
            else:
                full = _floats(inertial.get("fullinertia"))
                # Diagonalize the full inertia; MJCF order ixx iyy izz ixy ixz iyz
                I = np.array(
                    [
                        [full[0], full[3], full[4]],
                        [full[3], full[1], full[5]],
                        [full[4], full[5], full[2]],
                    ]
                )
                w, V = np.linalg.eigh(I)
                inertia = w
                # eigh may return a reflection (det V = -1); mat_to_quat on a
                # non-rotation would silently yield a different orientation.
                # Negating one eigenvector keeps V @ diag(w) @ V.T invariant.
                if np.linalg.det(V) < 0:
                    V = V * np.array([1.0, 1.0, -1.0])
                # Fold the eigenbasis into iquat (compose with given iquat).
                from ._np_quat import mat_to_quat, np_quat_mul

                iquat = np_quat_mul(iquat, mat_to_quat(V))
        else:
            ipos = np.zeros(3)
            iquat = np.array([1.0, 0, 0, 0])
            mass = 0.0
            inertia = np.zeros(3)

        spec = BodySpec(
            name=battrs.get("name", f"body{len(bodies)}"),
            parent=parent,
            pos=pos,
            quat=quat / np.linalg.norm(quat),
            ipos=ipos,
            iquat=iquat / np.linalg.norm(iquat),
            mass=mass,
            inertia=inertia,
        )
        idx = len(bodies)
        bodies.append(spec)

        for child in node:
            if child.tag == "freejoint":
                spec.joints.append(
                    JointSpec(
                        name=child.get("name", spec.name + "_free"),
                        jtype="free",
                        pos=np.zeros(3),
                        axis=np.array([0.0, 0, 1]),
                        range=np.array([-np.inf, np.inf]),
                        damping=0.0,
                        armature=0.0,
                    )
                )
            elif child.tag == "joint":
                attrs = defaults.resolve("joint", child.attrib, child.get("class", cls))
                rng = attrs.get("range")
                jtype = attrs.get("type", "hinge")
                jrange = _floats(rng) if rng else np.array([-np.inf, np.inf])
                if rng and jtype == "hinge":
                    # Angles honor compiler angle="degree"; slide ranges are
                    # lengths, ball ranges a max rotation (limits unsupported).
                    jrange = to_rad(jrange)
                spec.joints.append(
                    JointSpec(
                        name=attrs.get("name", f"{spec.name}_j{len(spec.joints)}"),
                        jtype=jtype,
                        pos=_floats(attrs.get("pos", "0 0 0")),
                        axis=_floats(attrs.get("axis", "0 0 1")),
                        range=jrange,
                        damping=float(attrs.get("damping", "0")),
                        armature=float(attrs.get("armature", "0")),
                    )
                )
            elif child.tag == "geom":
                attrs = defaults.resolve("geom", child.attrib, child.get("class", cls))
                spec.geoms.append(
                    GeomSpec(
                        name=attrs.get("name", f"{spec.name}_g{len(spec.geoms)}"),
                        gtype=attrs.get("type", "sphere"),
                        mesh=attrs.get("mesh"),
                        size=_floats(attrs.get("size", "0")),
                        pos=_floats(attrs.get("pos", "0 0 0")),
                        quat=frame_quat(attrs),
                        contype=int(attrs.get("contype", "1")),
                        conaffinity=int(attrs.get("conaffinity", "1")),
                    )
                )
            elif child.tag == "body":
                parse_body(child, idx, cls)

    for wb in root.findall("worldbody"):
        for child in wb.findall("body"):
            parse_body(child, -1, "")

    actuators: List[ActuatorSpec] = []
    for act in root.findall("actuator"):
        for child in act:
            if child.tag in ("motor", "general", "position"):
                attrs = defaults.resolve(child.tag, child.attrib, child.get("class", ""))
                cr = attrs.get("ctrlrange")
                actuators.append(
                    ActuatorSpec(
                        name=attrs.get("name", f"act{len(actuators)}"),
                        joint=attrs["joint"],
                        gear=float(attrs.get("gear", "1").split()[0]),
                        ctrlrange=_floats(cr) if cr else np.array([-np.inf, np.inf]),
                    )
                )

    keyframes: Dict[str, np.ndarray] = {}
    for kf in root.findall("keyframe"):
        for key in kf.findall("key"):
            if key.get("qpos"):
                keyframes[key.get("name", f"key{len(keyframes)}")] = _floats(key.get("qpos"))

    return MJCFSpec(
        model_name=root.get("model", "mjcf"),
        bodies=bodies,
        actuators=actuators,
        meshes=meshes,
        gravity=gravity,
        timestep=timestep,
        keyframes=keyframes,
    )
