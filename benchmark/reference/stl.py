"""[Frozen copy of mpc_ilqr_tpu_torch/models/stl.py, lines 1-65, with its imports made relative.]

Minimal STL mesh reader (binary and ASCII), numpy only.

Used at model-build time to derive foot contact points from the ankle
collision meshes — the reference relies on MuJoCo's mesh-vs-plane convex
collision (robot_utils.cpp contact solver setup); the engine instead
samples a small set of sole points and applies a smooth compliant contact
model at each, which keeps the dynamics differentiable.
"""
from __future__ import annotations

import struct

import numpy as np


def read_stl_vertices(path: str) -> np.ndarray:
    """Return the unique vertices (V, 3) float64 of an STL file."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:5] == b"solid" and b"facet" in raw[:1000]:
        verts = _parse_ascii(raw)
    else:
        verts = _parse_binary(raw)
    # Deduplicate to keep downstream processing cheap.
    return np.unique(np.round(verts, 9), axis=0)


def _parse_binary(raw: bytes) -> np.ndarray:
    (n_tri,) = struct.unpack_from("<I", raw, 80)
    data = np.frombuffer(raw, dtype=np.uint8, count=n_tri * 50, offset=84)
    data = data.reshape(n_tri, 50)
    # Each record: normal (3f), v0 (3f), v1 (3f), v2 (3f), attr (H)
    floats = data[:, :48].copy().view("<f4").reshape(n_tri, 12)
    return floats[:, 3:12].reshape(-1, 3).astype(np.float64)


def _parse_ascii(raw: bytes) -> np.ndarray:
    verts = []
    for line in raw.decode("ascii", errors="ignore").splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            parts = line.split()
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return np.asarray(verts, dtype=np.float64)


def sole_contact_points(verts: np.ndarray, slab: float = 0.004) -> np.ndarray:
    """Pick 4 corner points of the lowest-z slab of a foot mesh (body frame).

    Returns (4, 3): the axis-aligned xy bounding-box corners of all vertices
    within `slab` meters of the mesh minimum z, placed at that minimum z.
    """
    z_min = float(verts[:, 2].min())
    sole = verts[verts[:, 2] <= z_min + slab]
    x_lo, x_hi = float(sole[:, 0].min()), float(sole[:, 0].max())
    y_lo, y_hi = float(sole[:, 1].min()), float(sole[:, 1].max())
    return np.array(
        [
            [x_lo, y_lo, z_min],
            [x_lo, y_hi, z_min],
            [x_hi, y_lo, z_min],
            [x_hi, y_hi, z_min],
        ],
        dtype=np.float64,
    )
