"""Quaternion / rotation primitives (wxyz convention, MuJoCo-compatible).

Every function broadcasts over leading batch dimensions and is safe under
`torch.func` transforms (no in-place writes). Components are taken as
width-1 slices, never as 0-dim tensors: forward-mode AD promotes the tangent
of (python float × 0-dim float32 tensor) to float64.
"""
from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)


def cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Component-form cross product over the last axis (..., 3)."""
    u0, u1, u2 = u[..., 0:1], u[..., 1:2], u[..., 2:3]
    v0, v1, v2 = v[..., 0:1], v[..., 1:2], v[..., 2:3]
    return torch.cat([u1 * v2 - u2 * v1, u2 * v0 - u0 * v2, u0 * v1 - u1 * v0], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b, both wxyz."""
    aw, ax, ay, az = a[..., 0:1], a[..., 1:2], a[..., 2:3], a[..., 3:4]
    bw, bx, by, bz = b[..., 0:1], b[..., 1:2], b[..., 2:3], b[..., 3:4]
    return torch.cat(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:4]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q: R(q) @ v, as
    v + 2 w (u × v) + 2 u × (u × v)."""
    w, u = q[..., 0:1], q[..., 1:4]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) from quaternion(s) (..., 4) wxyz."""
    w, x, y, z = q[..., 0:1], q[..., 1:2], q[..., 2:3], q[..., 3:4]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack(
        [torch.cat([r00, r01, r02], dim=-1), torch.cat([r10, r11, r12], dim=-1),
         torch.cat([r20, r21, r22], dim=-1)],
        dim=-2,
    )


def quat_exp(phi: torch.Tensor) -> torch.Tensor:
    """Unit quaternion of the rotation vector phi (..., 3), series-safe at 0."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-24)
    half = 0.5 * theta
    k = torch.where(theta2 < 1e-12, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    return torch.cat([torch.cos(half), k * phi], dim=-1)


def quat_integrate(q: torch.Tensor, omega_local: torch.Tensor, dt) -> torch.Tensor:
    """q' = normalize(q ⊗ exp(dt ω_local)): body-local angular velocity,
    integrated on the right (MuJoCo free-joint convention)."""
    return quat_normalize(quat_mul(q, quat_exp(omega_local * dt)))


def quat_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit quaternion for a rotation of `angle` about unit `axis`."""
    half = 0.5 * angle[..., None]
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)
