"""The rank function of tests/test_torch_sharded.py: one process of a gloo
group on the CPU, spawned by `spawn_group`.

Each rank joins the group (its own timeout, so a hung rank fails its test),
builds the ("dp", "ls") mesh, runs every sharded function of the port
beside its local counterpart on the same inputs, and saves what it got to
`<out>/rank<r>.pt` for the test process to compare. Imports the port, torch
and numpy only: the JAX side of a comparison is computed by the test
process and handed over in the payload.
"""
import dataclasses
import datetime
import os
import pickle
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_group(world: int, payload: dict, out_dir: str) -> list:
    """Run `rank_main` in `world` spawned processes of one gloo group and
    return each rank's saved results, rank by rank."""
    path = os.path.join(out_dir, "payload.pkl")
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    mp.start_processes(rank_main, args=(world, free_port(), path, out_dir), nprocs=world,
                       join=True, start_method="spawn")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _arm(payload, dtype):
    from mpc_ilqr_tpu_torch import interop

    return (interop.model_from_numpy(payload["arm_model"], device="cpu", dtype=dtype),
            interop.cost_params_from_numpy(payload["arm_cp"], device="cpu", dtype=dtype),
            interop.refs_from_numpy(payload["arm_refs"], device="cpu", dtype=dtype))


def _h1_standing(n_horizon):
    """config.yaml's standing flagship in float64 on the plain chains."""
    from mpc_ilqr_tpu_torch.io.config import load_config
    from mpc_ilqr_tpu_torch.mpc import runner

    app = load_config(os.path.join(os.path.dirname(os.path.dirname(__file__)), "config.yaml"))
    app.q_ref_path, app.v_ref_path, app.contact_schedule_path = (
        "data/q_standing.csv", "data/v_standing.csv", "data/contact_standing.csv")
    app.engine.update(dtype="float64", rollout_backend="xla", ls_backend="xla")
    prob = runner.setup(app, device="cpu")
    return prob._replace(cfg=dataclasses.replace(prob.cfg, N=n_horizon, max_iterations=2,
                                                 cascade_p1_backend="xla"))


def _solution(sol):
    return {f: (v.clone() if torch.is_tensor(v) else v) for f, v in sol._asdict().items()}


def rank_main(rank, world, port, payload_path, out_dir):
    torch.set_num_threads(1)
    from mpc_ilqr_tpu_torch.costs.references import ReferenceWindow, extract_window
    from mpc_ilqr_tpu_torch.dynamics import engine
    from mpc_ilqr_tpu_torch.ilqr import solver as ilqr
    from mpc_ilqr_tpu_torch.models.robot import standing_state
    from mpc_ilqr_tpu_torch.parallel import fleet as fleet_mod
    from mpc_ilqr_tpu_torch.parallel.sharded_solve import sharded_line_search, solve_sharded
    from mpc_ilqr_tpu_torch.parallel.sharding import make_mesh, place_fleet, shard_fleet_step

    with open(payload_path, "rb") as f:
        payload = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = make_mesh(device_type="cpu")
        out = {"mesh_shape": tuple(mesh.shape), "coordinate": tuple(mesh.get_coordinate())}

        # (1) The reference's own inputs on the float32 arm (tests/test_sharded_solve.py).
        ref = payload["arm_ls"]
        m32, cp32, refs32 = _arm(payload, torch.float32)
        cfg = ilqr.ILQRConfig(N=ref["N"])
        win = ReferenceWindow(**{k: _t(v, torch.float32) for k, v in ref["win"].items()})
        args = [_t(ref[k], torch.float32) for k in ("x0", "xbar", "ubar", "K", "kff", "base")]
        out["ref_ls"] = sharded_line_search(mesh, m32, cp32, cfg)(win, *args)

        # (2) Each selection mode on the float64 arm against the local line search.
        m, cp, refs = _arm(payload, torch.float64)
        x0 = torch.tensor([0.05, -0.05, 0.0, 0.0], dtype=torch.float64)
        N = 4
        win = extract_window(refs, 0, N)
        ubar = engine.gravity_comp(m, x0)[None].repeat(N, 1)
        base_cfg = ilqr.ILQRConfig(N=N)
        xbar = ilqr.rollout(m, base_cfg, x0, ubar)
        A, B = ilqr.linearize(m, base_cfg, xbar, ubar)
        quad = ilqr.quadraticize(m, cp, win, xbar, ubar)
        K, kff = ilqr.backward_pass(A, B, quad, 1e-6, 1e-4)
        base = ilqr.trajectory_cost(m, cp, win, xbar, ubar)
        for mode in ("first_accept", "argmin", "cascade"):
            c = dataclasses.replace(base_cfg, line_search=mode)
            for label, b in (("", base), ("_no_improvement", base - 1e3)):
                out[f"ls_{mode}{label}"] = sharded_line_search(mesh, m, cp, c)(
                    win, x0, xbar, ubar, K, kff, b)
                out[f"local_{mode}{label}"] = ilqr.line_search(m, cp, c, win, x0, xbar, ubar, K,
                                                              kff, b)

        # (3) solve_sharded against the local solve: the arm, then H1 at N=3.
        c = ilqr.ILQRConfig(N=N, max_iterations=2)
        out["arm_solve_local"] = _solution(ilqr.solve(m, cp, c, x0, win, ubar))
        out["arm_solve_sharded"] = _solution(solve_sharded(mesh, m, cp, c, x0, win, ubar))
        h1 = _h1_standing(3)
        hx0 = standing_state(h1.model)
        hu = engine.gravity_comp(h1.model, hx0)[None].repeat(h1.cfg.N, 1)
        hwin = extract_window(h1.refs, 0, h1.cfg.N)
        assert h1.cfg.line_search == "cascade"  # config.yaml's; sharded, it is first_accept
        fa = dataclasses.replace(h1.cfg, line_search="first_accept")
        out["h1_solve_local"] = _solution(ilqr.solve(h1.model, h1.cp, fa, hx0, hwin, hu))
        out["h1_solve_local_cascade"] = _solution(ilqr.solve(h1.model, h1.cp, h1.cfg, hx0, hwin,
                                                             hu))
        out["h1_solve_sharded"] = _solution(solve_sharded(mesh, h1.model, h1.cp, h1.cfg, hx0,
                                                          hwin, hu))

        # (4) The fleet of 8 arm instances: sharded step against fleet_step_once.
        n = 8
        fcfg = ilqr.ILQRConfig(N=N, max_iterations=1)
        models = fleet_mod.randomized_models(m, torch.Generator().manual_seed(2), n)
        states = fleet_mod.fleet_init(models, fcfg, n)
        xs = x0[None].repeat(n, 1)
        _, u_all, d_all = fleet_mod.fleet_step_once(models, cp, fcfg, refs, states, xs)
        step = shard_fleet_step(mesh, place_fleet(mesh, models), cp, fcfg, refs)
        _, u_mine, _, mean_cost, n_ok = step(place_fleet(mesh, states), place_fleet(mesh, xs))
        parts = [torch.empty_like(u_mine) for _ in range(world)]
        dist.all_gather(parts, u_mine.contiguous())
        out.update(fleet_u_local=u_all, fleet_cost_local=d_all.cost,
                   fleet_ok_local=d_all.solve_ok, fleet_u_gathered=torch.cat(parts),
                   fleet_u_mine=u_mine, fleet_block=place_fleet(mesh, u_all),
                   fleet_mean_cost=mean_cost, fleet_n_ok=n_ok)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
