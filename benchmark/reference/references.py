"""[Frozen copy of mpc_ilqr_tpu_torch/costs/references.py, lines 1-53, with its imports made relative.]

Reference tracks and the clamped window the MPC reads each step."""
from __future__ import annotations

import dataclasses

import torch

TRACK_FIELDS = ("x", "u", "com", "com_vel", "ee_pos", "ee_vel", "stance")
WINDOW_FIELDS = ("x", "u", "com", "com_vel", "ee_pos", "stance")


@dataclasses.dataclass(frozen=True, eq=False)
class ReferenceSet:
    """Full reference tracks of length T."""

    x: torch.Tensor  # (T, nx)
    u: torch.Tensor  # (T, nu) — zeros in the reference pipeline
    com: torch.Tensor  # (T, 3)
    com_vel: torch.Tensor  # (T, 3)
    ee_pos: torch.Tensor  # (T, n_ee, 3)
    ee_vel: torch.Tensor  # (T, n_ee, 3)
    stance: torch.Tensor  # (T, n_ee) float 0/1 contact schedule

    @property
    def length(self) -> int:
        return self.x.shape[0]


@dataclasses.dataclass(frozen=True, eq=False)
class ReferenceWindow:
    """References for one horizon: N+1 states / N controls."""

    x: torch.Tensor  # (N+1, nx)
    u: torch.Tensor  # (N, nu)
    com: torch.Tensor  # (N+1, 3)
    com_vel: torch.Tensor  # (N+1, 3)
    ee_pos: torch.Tensor  # (N+1, n_ee, 3)
    stance: torch.Tensor  # (N+1, n_ee)


def extract_window(refs: ReferenceSet, t0, N: int) -> ReferenceWindow:
    """Rows t0..t0+N, indices past the track repeating its last row.

    t0 is an int, a 0-dim integer tensor or a vector of them (B,); a vector
    gives every field a leading axis B. A tensor t0 is gathered on its
    device with no host read (the reference's clamped gather)."""
    steps = torch.arange(N + 1, device=refs.x.device)
    idx = steps + (t0[..., None] if torch.is_tensor(t0) else int(t0))
    idx = torch.clamp(idx, 0, refs.length - 1)
    return ReferenceWindow(
        x=refs.x[idx], u=refs.u[idx[..., :N]], com=refs.com[idx], com_vel=refs.com_vel[idx],
        ee_pos=refs.ee_pos[idx], stance=refs.stance[idx],
    )
