"""The JAX package's sources behind the port's committed parity fixtures.

A fixture under tests/torch_fixtures/ holds the JAX package's outputs, made
once by a tools/port_*_fixture.py script because compiling the graphs takes
minutes on the CPU. `stamp` records, in the fixture, the repo-relative paths
of the reference's modules the script had imported (the mpc_ilqr_tpu
package and tools/bench_suite.py), a sha256 over their contents and the
script's name; tests/test_torch_fixtures.py recomputes the digest from the
tree and names the script to rerun when it differs.
"""
import hashlib
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_MODULES = ("mpc_ilqr_tpu", "bench_suite")


def loaded_reference_sources() -> list:
    """Repo-relative paths of the reference modules imported so far, sorted."""
    paths = set()
    for name, mod in list(sys.modules.items()):
        f = getattr(mod, "__file__", None)
        if name.split(".")[0] in REFERENCE_MODULES and f:
            paths.add(os.path.relpath(os.path.abspath(f), ROOT))
    return sorted(paths)


def digest(paths) -> str:
    """sha256 over each path and its bytes, in sorted order."""
    h = hashlib.sha256()
    for p in sorted(paths):
        h.update(p.encode() + b"\0")
        with open(os.path.join(ROOT, p), "rb") as f:
            h.update(f.read())
        h.update(b"\0")
    return h.hexdigest()


def stamp(out: dict, script: str) -> dict:
    """Add jax_sources, jax_digest and made_by to a fixture's arrays."""
    sources = loaded_reference_sources()
    out["jax_sources"] = np.array(sources)
    out["jax_digest"] = np.array(digest(sources))
    out["made_by"] = np.array(script)
    return out
