"""The line search sharded over a process group: a collective inside one
solve (mpc_ilqr_tpu/parallel/sharded_solve.py) over torch.distributed.

Each rank of the mesh's `axis` group rolls out its contiguous block of the
alphas — through `solver.rollout_alphas` on `cfg.ls_backend`, so K3 (or K2)
over the block's alphas on a CUDA tensor with a StepPlan — and one
`all_gather` over the group brings every rank every alpha's trajectory and
cost, in global order. Every rank then picks the same winner by the
reference's rule: the first improving alpha (for any mode but "argmin", so a
cascade collapses to first_accept over one batch) or the cheapest one;
best_cost is the least cost. The gather moves bytes, so a world of one
gives the local line search's result to the last bit.

A process group must be initialised (`torch.distributed.init_process_group`
with its address, world size and rank); see parallel/sharding.py.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from mpc_ilqr_tpu_torch.costs.params import CostParams
from mpc_ilqr_tpu_torch.costs.references import ReferenceWindow
from mpc_ilqr_tpu_torch.ilqr import solver as ilqr
from mpc_ilqr_tpu_torch.models.robot import RobotModel, static_tensor
from mpc_ilqr_tpu_torch.mpc import controller


def require_group(what: str) -> None:
    """Raise unless a torch.distributed process group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"{what} needs an initialised torch.distributed process group "
                           f"(init_process_group with its address, world size and rank)")


def sharded_line_search(mesh, model: RobotModel, cp: CostParams, cfg: ilqr.ILQRConfig,
                        axis: str = "ls", plan=None):
    """A line search whose alphas are split over the ranks of `mesh`'s
    `axis`: ls_fn(win, x0, xbar, ubar, K, kff, baseline) -> (accepted, xs,
    us, cost, best_cost), `ilqr.line_search`'s contract (accepted a bool).
    len(cfg.alphas) must divide evenly over the axis."""
    require_group("sharded_line_search")
    dim = mesh.mesh_dim_names.index(axis)
    group, size = mesh.get_group(dim), mesh.shape[dim]
    n_alpha = len(cfg.alphas)
    assert n_alpha % size == 0, f"{n_alpha} alphas over {size} ranks"
    per = n_alpha // size
    block = cfg.alphas[dist.get_rank(group) * per:(dist.get_rank(group) + 1) * per]

    def ls_fn(win: ReferenceWindow, x0, xbar, ubar, K, kff, baseline_cost):
        alphas = static_tensor(block, x0.device, x0.dtype)
        xs_b, us_b, costs = ilqr.rollout_alphas(model, cp, cfg, win, x0, xbar, ubar, K, kff,
                                                alphas, cfg.ls_backend, plan)
        # One gather of [xs | us | cost] per alpha, rank by rank: global alpha order.
        n_x, n_u = xs_b[0].numel(), us_b[0].numel()
        mine = torch.cat([xs_b.reshape(per, n_x), us_b.reshape(per, n_u), costs[:, None]], dim=1)
        parts = [torch.empty_like(mine) for _ in range(size)]
        dist.all_gather(parts, mine.contiguous(), group=group)
        rows = torch.cat(parts, dim=0)
        costs_all = rows[:, -1]
        accepted, idx = ilqr.pick_alpha(cfg, costs_all, baseline_cost)
        row = rows.index_select(0, idx[None])[0]
        return (bool(accepted), row[:n_x].reshape(xs_b.shape[1:]),
                row[n_x:n_x + n_u].reshape(us_b.shape[1:]), row[-1], costs_all.min())

    return ls_fn


def solve_sharded(mesh, model, cp, cfg, x0, win, ubar_init, plan=None, **kw):
    """`ilqr.solve` with the line search sharded over the mesh's "ls" axis."""
    ls = sharded_line_search(mesh, model, cp, cfg, plan=plan)
    return ilqr.solve(model, cp, cfg, x0, win, ubar_init, plan=plan, ls_fn=ls, **kw)


def step_once_sharded(mesh, model, cp, cfg, refs, state, x_measured, plan=None):
    """`controller.step_once` with the sharded line search composed in."""
    ls = sharded_line_search(mesh, model, cp, cfg, plan=plan)
    return controller.step_once(model, cp, cfg, refs, state, x_measured, plan=plan, ls_fn=ls)
