"""The standing step's parts, timed for one tree of the port: run it on a
machine with the GPU, once per tree in turns, to compare two commits in one
call.

    git archive <commit> mpc_ilqr_tpu_torch | tar -x -C logs/parent
    for t in logs/parent . . logs/parent; do python3 tools/port_parts_ab.py $t; done

Imports mpc_ilqr_tpu_torch from the given tree (its root: the directory
holding mpc_ilqr_tpu_torch/) and this checkout's config.yaml and data, sets
up the standing flagship on the plain chains (no kernel: the parts that do
not depend on the CUDA sources) and prints the host-clock ms per call of
one dynamics step, a plain N=25 rollout, linearize, quadraticize_gn, the
trajectory cost and one cold MPC step, after one warm-up each.
"""
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE = os.path.abspath(sys.argv[1])
sys.path.insert(0, TREE)

import torch  # noqa: E402

import mpc_ilqr_tpu_torch  # noqa: E402
from mpc_ilqr_tpu_torch.costs.quadratics import quadraticize_gn, trajectory_costs  # noqa: E402
from mpc_ilqr_tpu_torch.costs.references import extract_window  # noqa: E402
from mpc_ilqr_tpu_torch.dynamics import engine  # noqa: E402
from mpc_ilqr_tpu_torch.ilqr import solver  # noqa: E402
from mpc_ilqr_tpu_torch.io.config import load_config  # noqa: E402
from mpc_ilqr_tpu_torch.models.robot import standing_state  # noqa: E402
from mpc_ilqr_tpu_torch.mpc import controller, runner  # noqa: E402
from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk  # noqa: E402


def main():
    if not mpc_ilqr_tpu_torch.__file__.startswith(TREE):
        raise SystemExit(f"imported {mpc_ilqr_tpu_torch.__file__}, not the tree {TREE}")
    app = load_config(os.path.join(ROOT, "config.yaml"))
    app.q_ref_path, app.v_ref_path, app.contact_schedule_path = (
        "data/q_standing.csv", "data/v_standing.csv", "data/contact_standing.csv")
    app.engine["rollout_backend"] = app.engine["ls_backend"] = "xla"
    prob = runner.setup(app)
    m, cp, refs = prob.model, prob.cp, prob.refs
    cfg = dataclasses.replace(prob.cfg, cascade_p1_backend="xla")
    x = standing_state(m)
    u = engine.gravity_comp(m, x)
    us = u[None].repeat(cfg.N, 1).contiguous()
    xs = rk.rollout_plain(m, x, us)
    win = extract_window(refs, 0, cfg.N)
    parts = {
        "engine.step": lambda: engine.step(m, x, u),
        "rollout_plain N=25": lambda: rk.rollout_plain(m, x, us),
        "linearize N=25": lambda: solver.linearize(m, cfg, xs, us),
        "quadraticize_gn": lambda: quadraticize_gn(m, cp, win, xs, us),
        "trajectory_costs": lambda: trajectory_costs(m, cp, win, xs[None], us[None]),
        "step_once (plain chains)": lambda: controller.step_once(
            m, cp, cfg, refs, controller.init_state(m, cfg), x),
    }
    res = {}
    for name, f in parts.items():
        f()
        torch.cuda.synchronize()
        reps = 3 if "step_once" in name else 10
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        torch.cuda.synchronize()
        res[name] = round((time.perf_counter() - t0) * 1e3 / reps, 2)
    print(os.path.relpath(TREE, ROOT), torch.cuda.get_device_name(0), res)


if __name__ == "__main__":
    main()
