"""H1 with hands (nx=103, nu=45) through the port on the CPU against the JAX
package's own outputs on the same problem (tests/torch_fixtures/hands_h1.npz,
made by tools/port_hands_fixture.py: compiling the engine on the 46-body
tree takes minutes). The port builds the problem with chip_smoke's
hands_problem at the fixture's N=5, float64: the dimensions, the cold-start
rollout from standing at gravity compensation, linearize
(structured_frozen_mass) and the GN quadratics along it, K4 (its plain
version, what the wrapper runs on CPU tensors) on their float32 copies, and
a 2-iteration solve with backward "pallas"."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from chip_smoke import RICCATI_ATOL, hands_problem
from mpc_ilqr_tpu_torch.costs.quadratics import quadraticize_gn
from mpc_ilqr_tpu_torch.costs.references import extract_window
from mpc_ilqr_tpu_torch.dynamics import engine
from mpc_ilqr_tpu_torch.ilqr import solver
from mpc_ilqr_tpu_torch.models.robot import standing_state
from mpc_ilqr_tpu_torch.ops import riccati

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "torch_fixtures", "hands_h1.npz")
QUAD = ("lx", "lu", "lxx", "luu")
# The reference's K4 rounds its inputs and gains to float32 inside the
# float64 solve (mpc_ilqr_tpu/ops/riccati.py:156-186); the port's plain
# version keeps float64. Over 2 iterations that moves ubar by 5.8e-6 and
# xbar by 6.2e-8 (the cost by 2.8e-9 relative); the bars leave ubar a
# margin of ~3x.
SOLVE_RTOL, SOLVE_ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def port(fx):
    """The port's problem and its cold start at the fixture's N, float64."""
    N = int(fx["N"])
    prob = hands_problem(N, float(fx["dt"]), device="cpu", dtype=torch.float64)
    m = prob.model
    x0 = standing_state(m)
    us = engine.gravity_comp(m, x0)[None].repeat(N, 1)
    win = extract_window(prob.refs, 0, N)
    xs = solver.rollout(m, prob.cfg, x0, us, plan=prob.plan)
    return prob, x0, us, win, xs


def test_the_problem_and_its_cold_start_match_the_reference(fx, port):
    prob, x0, us, _, xs = port
    m = prob.model
    assert (m.nq, m.nv, m.nu, m.ncp, m.nx) == (int(fx["nq"]), int(fx["nv"]), int(fx["nu"]),
                                               int(fx["ncp"]), 103)
    assert (prob.cfg.backward, prob.cfg.linearization, prob.cfg.quad_mode) == (
        "pallas", "structured_frozen_mass", "gn")
    np.testing.assert_allclose(x0.numpy(), fx["x0"], rtol=0, atol=0)
    np.testing.assert_allclose(us.numpy(), fx["us"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(xs.numpy(), fx["xs"], rtol=0, atol=1e-10)


def test_linearize_and_gn_quadratics_match_the_reference(fx, port):
    """float64, at the reference's inputs (its rollout, its controls)."""
    prob, _, _, win, _ = port
    xs, us = torch.tensor(fx["xs"]), torch.tensor(fx["us"])
    A, B = solver.linearize(prob.model, prob.cfg, xs, us)
    np.testing.assert_allclose(A.numpy(), fx["A"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(B.numpy(), fx["B"], rtol=0, atol=1e-9)
    q = quadraticize_gn(prob.model, prob.cp, win, xs, us)
    for f in QUAD:
        np.testing.assert_allclose(getattr(q, f).numpy(), fx[f], rtol=1e-10, atol=1e-9,
                                   err_msg=f)


def test_k4_on_the_hands_inputs_matches_the_pallas_kernel(fx):
    """The wrapper on CPU tensors (the plain version) on the float32 copies
    of the reference's A, B and quadratics, against float64 no further than
    the reference's own float32 kernel (its Pallas kernel in interpret mode)
    is: max |port - plain64| <= atol + 2 max |reference - plain64|, K and
    kff each (chip_smoke phase 5's bar, with the reference as the float32
    yardstick). |K| reaches ~2.3e3 here, so the random problems' rtol 2e-3
    / atol 2e-4 (tests/test_ops.py:36-37) does not apply to every entry:
    two float32 passes part by ~5e-2 there (the port 0.127 from float64,
    the reference 0.083)."""
    args = [torch.tensor(fx[k], dtype=torch.float32) for k in ("A", "B", *QUAD)]
    reg, pd = float(fx["reg"]), float(fx["pd_bump"])
    got = riccati.backward_pass_kernel(*args, reg, pd)
    want64 = riccati.backward_pass_plain(*(a.double() for a in args), reg, pd)
    for out, g, ref, w in zip(("K", "kff"), got, (fx["K"], fx["kff"]), want64):
        assert bool(torch.isfinite(g).all()), out
        w = w.numpy()
        bar = RICCATI_ATOL + 2.0 * float(np.abs(ref - w).max())
        assert float(np.abs(g.numpy() - w).max()) <= bar, out


def test_two_iteration_solve_with_k4_matches_the_reference(fx, port):
    """config.yaml's solver with backward "pallas", 2 iterations from the
    cold start, float64 (the reference's kernel in float32 inside it): the
    same iterations and success, the solution at SOLVE_RTOL / SOLVE_ATOL;
    and the port's own solve with backward "scan" where the port keeps
    float64 throughout."""
    prob, x0, us, win, _ = port
    cfg = dataclasses.replace(prob.cfg, max_iterations=2)
    sol = solver.solve(prob.model, prob.cp, cfg, x0, win, us, plan=prob.plan)
    assert sol.iterations == int(fx["solve_iterations"])
    assert sol.success == bool(fx["solve_success"])
    for f in ("xbar", "ubar", "cost", "reg"):
        np.testing.assert_allclose(np.asarray(getattr(sol, f)), fx[f"solve_{f}"], rtol=SOLVE_RTOL,
                                   atol=SOLVE_ATOL, err_msg=f)
    scan = solver.solve(prob.model, prob.cp, dataclasses.replace(cfg, backward="scan"), x0, win,
                        us, plan=prob.plan)
    assert (scan.iterations, scan.success) == (sol.iterations, sol.success)
    np.testing.assert_allclose(scan.ubar.numpy(), sol.ubar.numpy(), rtol=0, atol=1e-9)
