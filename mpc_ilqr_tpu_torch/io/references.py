"""Reference CSV loading and the precomputed task tracks.

Reads headerless q/v CSVs (or their .npz/.npy twins) with numpy, then
computes the CoM / CoM-velocity / EE-position / EE-velocity tracks for every
row with one batched FK. Contact schedules are CSVs with a
`left_foot,right_foot` header of 0/1 rows; rows past the schedule default to
stance.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import vmap

from mpc_ilqr_tpu_torch.costs.references import ReferenceSet
from mpc_ilqr_tpu_torch.dynamics import kinematics as kin
from mpc_ilqr_tpu_torch.models.robot import RobotModel


def load_csv_matrix(path: str, skip_rows: int = 0) -> np.ndarray:
    """Float matrix from a CSV (or the first array of an .npz, or an .npy)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return np.atleast_2d(np.asarray(z[list(z.files)[0]], dtype=np.float64))
    if path.endswith(".npy"):
        return np.atleast_2d(np.load(path).astype(np.float64))
    return np.atleast_2d(np.loadtxt(path, delimiter=",", skiprows=skip_rows, dtype=np.float64))


def load_contact_schedule(path: str, n_ee: int = 2) -> np.ndarray:
    """Contact CSV with a header row -> (T, n_ee) float 0/1."""
    data = load_csv_matrix(path, skip_rows=1)
    if data.shape[1] != n_ee:
        raise ValueError(f"contact schedule has {data.shape[1]} columns, expected {n_ee}")
    return data


def build_reference_set(model: RobotModel, q_track: np.ndarray, v_track: np.ndarray,
                        contact: Optional[np.ndarray] = None, dtype=None) -> ReferenceSet:
    dtype = dtype or model.dtype
    dev = model.device
    T = min(len(q_track), len(v_track))
    q = torch.as_tensor(np.array(q_track[:T]), dtype=dtype, device=dev)
    v = torch.as_tensor(np.array(v_track[:T]), dtype=dtype, device=dev)
    if q.shape[1] != model.nq or v.shape[1] != model.nv:
        raise ValueError(f"reference dims mismatch: q {q.shape[1]} (want {model.nq}), "
                         f"v {v.shape[1]} (want {model.nv})")
    n_ee = len(model.ee_body_idx)
    sched = np.ones((T, n_ee))
    if contact is not None:
        L = min(T, len(contact))
        sched[:L] = contact[:L]
    return ReferenceSet(
        x=torch.cat([q, v], dim=1),
        u=torch.zeros((T, model.nu), dtype=dtype, device=dev),  # zero control reference
        com=vmap(lambda qq: kin.com_position(model, qq))(q),
        com_vel=vmap(lambda qq, vv: kin.com_velocity(model, qq, vv))(q, v),
        ee_pos=vmap(lambda qq: kin.ee_positions(model, qq))(q),
        ee_vel=vmap(lambda qq, vv: kin.ee_velocities(model, qq, vv))(q, v),
        stance=torch.as_tensor(sched, dtype=dtype, device=dev),
    )


def load_reference_set(model: RobotModel, q_path: str, v_path: str,
                       contact_path: Optional[str] = None, dtype=None) -> ReferenceSet:
    contact = load_contact_schedule(contact_path) if contact_path else None
    return build_reference_set(model, load_csv_matrix(q_path), load_csv_matrix(v_path),
                               contact, dtype=dtype)
