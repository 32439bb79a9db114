"""Closed-loop H1 MPC command line of the port — the reference's humanoid_mpc executable.

Usage:
    python -m mpc_ilqr_tpu_torch.run_mpc [--config config.yaml] [--steps N]
        [--standing] [--profile] [--quiet] [--cpu]

Reads config.yaml, runs the receding-horizon MPC against the built-in
differentiable physics on the card ("cuda"; it fails where there is none),
or on the CPU with --cpu. Writes the step log (<logs_dir>/mpc_log.csv) and,
with logging.save_trajectories, <results_path>/q_optimal.csv and
u_optimal.csv with the reference's headers; prints the per-step line
`Step k/N | Cost: ... | (X,Y,Z): ...` (humanoid_mpc.cpp:172-178) and, with
--profile, the timing/memory table (humanoid_mpc.cpp:195-226). With
`--plant mujoco` the plant is a MuJoCo simulation with the reference's
solver settings (mpc/mujoco_plant.py); it needs the mujoco package and so
runs only where that is installed. The same
flags and lines as the JAX package's run_mpc.py.
"""
import argparse
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mpc_ilqr_tpu_torch.run_mpc")
    ap.add_argument("--config", default=os.path.join(ROOT, "config.yaml"))
    ap.add_argument("--steps", type=int, default=None, help="override mpc.sim_steps")
    ap.add_argument("--standing", action="store_true",
                    help="use the standing references/contact schedule instead of walking")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--plant", choices=["engine", "mujoco"], default="engine",
                    help="plant physics: the built-in differentiable engine (reference-style "
                         "self-consistent sim) or a real MuJoCo simulation (cross-plant "
                         "validation; needs mujoco)")
    args = ap.parse_args(argv)
    if args.plant == "mujoco":
        from mpc_ilqr_tpu_torch.mpc import mujoco_plant

        try:
            mujoco_plant.import_mujoco()
        except ImportError as e:
            ap.error(str(e))
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device: this runs on the card unless --cpu is given", file=sys.stderr)
        return 1

    from mpc_ilqr_tpu_torch.io import logging as iolog
    from mpc_ilqr_tpu_torch.io.config import load_config
    from mpc_ilqr_tpu_torch.mpc import runner
    from mpc_ilqr_tpu_torch.utils.profiling import Profiler

    app = load_config(args.config)
    if args.standing:
        app.q_ref_path = "data/q_standing.csv"
        app.v_ref_path = "data/v_standing.csv"
        app.contact_schedule_path = "data/contact_standing.csv"
    print(f"Configuration loaded from {args.config}")

    prob = runner.setup(app, device="cpu" if args.cpu else "cuda")
    model = prob.model
    print(f"Model loaded: nx={model.nx}, nu={model.nu} | horizon N={prob.cfg.N} "
          f"dt={app.mpc.dt} | references: {prob.refs.length} rows | device: {model.device}")

    prof = Profiler(enabled=True)
    if args.plant == "mujoco":
        steps = args.steps if args.steps is not None else app.mpc.sim_steps
        t0 = time.perf_counter()
        hist = mujoco_plant.run_mujoco_in_the_loop(prob, steps, verbose=not args.quiet)
        wall = (time.perf_counter() - t0) * 1e3
        print(f"MuJoCo-plant simulation completed in {wall:.0f} ms "
              f"({wall / max(1, steps):.1f} ms/step); final base z "
              f"{hist['x'][-1][2]:.4f}, final cost {hist['cost'][-1]:.4f}")
        if args.profile:
            print(prof.report())
        return 0

    step_logger = iolog.StepLogger(
        os.path.join(app.resolve(app.logs_dir), "mpc_log.csv"), model.nx, model.nu)
    traj_logger = (iolog.OptimalTrajectoryLogger(app.resolve(app.results_path), model.nq, model.nu)
                   if app.save_trajectories else None)

    t0 = time.perf_counter()
    hist, _ = runner.run_simulation(prob, sim_steps=args.steps, verbose=not args.quiet,
                                    profiler=prof, step_logger=step_logger,
                                    traj_logger=traj_logger)
    wall = (time.perf_counter() - t0) * 1e3
    n = max(1, len(hist["cost"]))
    print(f"Simulation completed in {wall:.0f} ms")
    print(f"Average step time: {wall / n:.2f} ms")
    if len(hist["solve_ms"]) > 1:
        steady = hist["solve_ms"][1:]
        print(f"Steady-state solve: {sum(steady)/len(steady):.2f} ms "
              f"(first step incl. compile: {hist['solve_ms'][0]:.0f} ms)")
    if args.profile:
        print(prof.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
