"""[Frozen copy of mpc_ilqr_tpu_torch/models/_np_quat.py, lines 1-71, with its imports made relative.]

Numpy quaternion helpers for model-build time (wxyz convention)."""
from __future__ import annotations

import numpy as np


def np_quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def mat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion wxyz (robust Shepperd method)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(R)))
    if i == 0:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s]
    elif i == 1:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s]
    return np.array(q)


def np_axis_angle_quat(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2.0)], np.sin(angle / 2.0) * axis])


def np_euler_to_quat(angles: np.ndarray, seq: str = "xyz") -> np.ndarray:
    """MJCF euler attribute -> quaternion (wxyz), angles in RADIANS.

    MuJoCo semantics (compiler eulerseq): rotations compose in sequence
    order; lowercase letters rotate about the axes of the moving frame
    (right-multiply), uppercase about the fixed parent frame
    (left-multiply). Verified against mujoco in test_model_generality.
    """
    axes = {"x": [1.0, 0, 0], "y": [0, 1.0, 0], "z": [0, 0, 1.0]}
    q = np.array([1.0, 0, 0, 0])
    for ch, ang in zip(seq, np.asarray(angles, dtype=np.float64)):
        r = np_axis_angle_quat(axes[ch.lower()], float(ang))
        q = np_quat_mul(q, r) if ch.islower() else np_quat_mul(r, q)
    return q / np.linalg.norm(q)


def np_quat_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
