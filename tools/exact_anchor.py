"""The JAX package's own run of chip_smoke.py phase 9 (a), on the CPU.

    JAX_PLATFORMS=cpu python tools/exact_anchor.py [--steps N]

config.yaml with the standing references and the reference's default
derivatives (linearization "ad", quad_mode "exact"; tools/bench_suite.py's
`_setup(standing=True)` with `--lin ad --quad exact`), float32, N=25:
controller.run_closed_loop for 15 MPC steps from the standing state, as
one jitted graph. Prints each step's cost, iterations, solve_ok and base z,
then the numbers chip_smoke.EXACT_ANCHOR records: the steps, every
solve_ok, the first and the final cost, the final base z and the mean
iterations per step. Compiling the graph takes minutes on one core.
"""
import argparse
import dataclasses
import functools
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mpc_ilqr_tpu.io.config import load_config  # noqa: E402
from mpc_ilqr_tpu.models.robot import standing_state  # noqa: E402
from mpc_ilqr_tpu.mpc import controller, runner  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=15)
    args = ap.parse_args()
    app = load_config(os.path.join(ROOT, "config.yaml"))
    app.q_ref_path = "data/q_standing.csv"
    app.v_ref_path = "data/v_standing.csv"
    app.contact_schedule_path = "data/contact_standing.csv"
    prob = runner.setup(app)
    cfg = dataclasses.replace(prob.cfg, linearization="ad", quad_mode="exact")
    m = prob.model
    run = jax.jit(functools.partial(controller.run_closed_loop, m, prob.cp, cfg,
                                    n_steps=args.steps, plan=prob.plan))
    t0 = time.perf_counter()
    _, xT, h = jax.block_until_ready(run(prob.refs, controller.init_state(m, cfg),
                                         standing_state(m)))
    wall = time.perf_counter() - t0
    cost, its = np.asarray(h["cost"]), np.asarray(h["iterations"])
    oks, xs = np.asarray(h["solve_ok"]), np.asarray(h["x"])
    for i in range(args.steps):
        print(f"step {i:2d}: cost {cost[i]:.6f}  iterations {its[i]}  solve_ok {oks[i]}  "
              f"base_z {xs[i, 2]:.6f}")
    print(f"jax package, exact standing (ad + exact), N={cfg.N}, {m.body_pos.dtype}, CPU: "
          f"{args.steps} steps, solve_ok {int(oks.sum())} of {args.steps}, first cost "
          f"{cost[0]:.6f}, final cost {cost[-1]:.6f}, final base z {float(xT[2]):.6f}, "
          f"{its.mean():.3f} iterations per step; wall {wall:.1f} s with the compile")
    print(dict(steps=args.steps, solve_ok=int(oks.sum()), first_cost=round(float(cost[0]), 6),
               final_cost=round(float(cost[-1]), 6), base_z=round(float(xT[2]), 6),
               iterations_per_step=round(float(its.mean()), 4)))


if __name__ == "__main__":
    main()
