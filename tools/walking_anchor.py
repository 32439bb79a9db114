"""The walking run's quality numbers, from either package on the CPU.

    JAX_PLATFORMS=cpu python tools/walking_anchor.py [--package jax|port]
        [--steps N] [--out DIR]

Runs config.yaml as shipped (the walking references and contact schedule,
N=25, float32, mpc.sim_steps unless --steps) through the package's
`runner.run_simulation` with its own step and trajectory loggers writing
under DIR (default logs/walking_anchor_<package>/), as `python run_mpc.py
--cpu --quiet` (or the port's `python -m mpc_ilqr_tpu_torch.run_mpc --cpu
--quiet`) does, recording each step's solve_ok on the way. Prints the steps
run, the failed solves and whether run_simulation's abort (a failed solve
past step 15) ended the run, the final cost and base z, base z's range,
base X/Y/Z's mean and max tracking error against the logged reference rows
(chip_smoke.walking_quality) and the wall time. The JAX package's numbers
are chip_smoke.WALK_ANCHOR, the bar of its walking phase.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import recording_waits, walking_quality  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=["jax", "port"], default="jax")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = args.out or os.path.join(ROOT, "logs", f"walking_anchor_{args.package}")
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from mpc_ilqr_tpu.io import logging as iolog
        from mpc_ilqr_tpu.io.config import load_config
        from mpc_ilqr_tpu.mpc import runner

        wait_module, setup = jax, runner.setup
    else:
        from mpc_ilqr_tpu_torch.io import logging as iolog
        from mpc_ilqr_tpu_torch.io.config import load_config
        from mpc_ilqr_tpu_torch.mpc import runner

        wait_module, setup = runner, lambda app: runner.setup(app, device="cpu")
    app = load_config(os.path.join(ROOT, "config.yaml"))
    prob = setup(app)
    m = prob.model
    log = os.path.join(out, "mpc_log.csv")
    oks = []
    inner = wait_module.block_until_ready
    wait_module.block_until_ready = recording_waits(wait_module, oks)
    t0 = time.perf_counter()
    try:
        hist, _ = runner.run_simulation(
            prob, sim_steps=args.steps, verbose=False,
            step_logger=iolog.StepLogger(log, m.nx, m.nu),
            traj_logger=iolog.OptimalTrajectoryLogger(os.path.join(out, "results"), m.nq, m.nu))
    finally:
        wait_module.block_until_ready = inner
    wall = time.perf_counter() - t0
    failed = [i for i, ok in enumerate(oks) if not ok]
    q = walking_quality(log)
    steps = args.steps if args.steps is not None else app.mpc.sim_steps
    print(f"{args.package} package, walking config.yaml, N={prob.cfg.N}, float32, CPU: "
          f"{len(hist['cost'])} of {steps} steps run; solve_ok {len(oks) - len(failed)} of "
          f"{len(oks)}, failed at {failed}, abort {any(i > 15 for i in failed)}")
    print(f"  final cost {q['final_cost']}, final base z {q['base_z']}, base z in "
          f"[{q['z_min']}, {q['z_max']}]")
    print(f"  tracking |x - x_ref| base X/Y/Z: mean {q['mean_err']}, max {q['max_err']}")
    print(f"  wall {wall:.1f} s ({wall * 1e3 / max(1, len(hist['cost'])):.1f} ms per step, the "
          f"first step's compile included: {hist['solve_ms'][0]:.0f} ms); logs under {out}")


if __name__ == "__main__":
    main()
