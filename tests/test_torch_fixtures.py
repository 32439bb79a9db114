"""The port's committed parity fixtures are current.

Each tests/torch_fixtures/*.npz holds the JAX package's outputs for a parity
test whose reference graph takes minutes to compile, with the repo-relative
paths of the JAX sources its script had imported, a sha256 over them and
the script's name (tools/port_fixture_sources.py). The JAX package is
frozen, so a changed digest means an accident or a deliberate change to
it: either way the fixture no longer says what the reference computes, and
the failure names the script to rerun.
"""
import glob
import os
import sys

import numpy as np
import pytest

from test_torch_common import ROOT

sys.path.insert(0, os.path.join(ROOT, "tools"))
from port_fixture_sources import digest  # noqa: E402

FIXTURES = sorted(glob.glob(os.path.join(ROOT, "tests", "torch_fixtures", "*.npz")))


def test_every_fixture_is_checked():
    names = {os.path.basename(p) for p in FIXTURES}
    assert {"exact_h1.npz", "fd32_h1.npz", "fleet_h1.npz", "hands_h1.npz",
            "long_horizon_h1.npz", "mujoco_h1.npz", "nominal_h1.npz", "slice_h1.npz",
            "walking_h1.npz"} <= names


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_fixture_digest_matches_the_reference_sources(path):
    name = os.path.basename(path)
    with np.load(path) as fx:
        assert {"jax_sources", "jax_digest", "made_by"} <= set(fx.files), (
            f"{name} carries no digest of the JAX sources it was made from")
        sources = [str(p) for p in fx["jax_sources"]]
        want, made_by = str(fx["jax_digest"]), str(fx["made_by"])
    assert "mpc_ilqr_tpu/__init__.py" in sources, f"{name}: no JAX package source recorded"
    rerun = f"rerun `JAX_PLATFORMS=cpu python {made_by}`"
    missing = [p for p in sources if not os.path.exists(os.path.join(ROOT, p))]
    assert not missing, f"{name} is stale: {missing} no longer exist; {rerun}"
    assert digest(sources) == want, (
        f"{name} is stale: the JAX sources it was made from changed since; {rerun}")
