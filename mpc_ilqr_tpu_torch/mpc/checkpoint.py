"""Checkpoint / resume for the MPC carry.

The reference keeps its warm-start store in process memory (SURVEY §5:
prev_xbar_/prev_ubar_/prev_K_, mpc.cpp:108-112). Here the solve-to-solve
state is one MPCState, saved as an .npz with the JAX package's field names
and dtypes (t_idx int32 and has_prev bool as 0-d arrays), so a file written
by either package loads in the other. `set_time_index` is the reference's
setTimeIndex (mpc.hpp:27).
"""
from __future__ import annotations

import numpy as np
import torch

from mpc_ilqr_tpu_torch.mpc.controller import MPCState

_TENSORS = ("prev_xbar", "prev_ubar", "prev_K", "reg")


def save_state(path: str, state: MPCState) -> None:
    arrays = {k: getattr(state, k).detach().cpu().numpy() for k in _TENSORS}
    np.savez(path, t_idx=np.asarray(state.t_idx, np.int32),
             has_prev=np.asarray(state.has_prev, np.bool_), **arrays)


def load_state(path: str, dtype=torch.float32, device=None) -> MPCState:
    """The saved state with its tensors on `device` (default "cuda") in `dtype`."""
    device = torch.device("cuda" if device is None else device)
    with np.load(path) as z:
        return MPCState(
            t_idx=int(z["t_idx"]),
            has_prev=bool(z["has_prev"]),
            **{k: torch.as_tensor(z[k], dtype=dtype, device=device) for k in _TENSORS},
        )


def set_time_index(state: MPCState, t_idx: int) -> MPCState:
    """Reposition in the reference track (MPC::setTimeIndex)."""
    return state.replace(t_idx=int(t_idx))
