"""Carry the JAX package's arrays into the port.

Each function takes the reference objects' fields as numpy arrays (and the
static fields as plain Python values) in a dict and returns the port's
object on `device` in `dtype`. Arrays keep their shape, so a batched
model or state (a leading fleet axis on every array) comes over as one.
The tests build both sides from one source this way; nothing here imports
the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from mpc_ilqr_tpu_torch.costs.params import WEIGHT_FIELDS, CostParams
from mpc_ilqr_tpu_torch.costs.references import TRACK_FIELDS, ReferenceSet
from mpc_ilqr_tpu_torch.models.robot import ARRAY_FIELDS, STATIC_FIELDS, RobotModel
from mpc_ilqr_tpu_torch.mpc.controller import MPCState


def _t(a, device, dtype):
    return torch.as_tensor(np.array(a, dtype=np.float64), dtype=dtype, device=device)


def model_from_numpy(d: dict, device="cuda", dtype=torch.float32) -> RobotModel:
    static = {f: (tuple(d[f]) if isinstance(d[f], (list, tuple)) else d[f]) for f in STATIC_FIELDS}
    return RobotModel(**static, **{f: _t(d[f], device, dtype) for f in ARRAY_FIELDS})


def cost_params_from_numpy(d: dict, device="cuda", dtype=torch.float32) -> CostParams:
    return CostParams(**{f: _t(d[f], device, dtype) for f in WEIGHT_FIELDS},
                      quat_tangent=bool(d.get("quat_tangent", False)))


def refs_from_numpy(d: dict, device="cuda", dtype=torch.float32) -> ReferenceSet:
    return ReferenceSet(**{f: _t(d[f], device, dtype) for f in TRACK_FIELDS})


def mpc_state_from_numpy(d: dict, device="cuda", dtype=torch.float32) -> MPCState:
    """The state of step_once_device (t_idx int64 and has_prev bool tensors)."""
    return MPCState(
        t_idx=torch.as_tensor(np.asarray(d["t_idx"], dtype=np.int64), device=device),
        has_prev=torch.as_tensor(np.asarray(d["has_prev"], dtype=bool), device=device),
        **{f: _t(d[f], device, dtype) for f in ("prev_xbar", "prev_ubar", "prev_K", "reg")})
