"""A ("dp", "ls") device mesh over torch.distributed for the fleet
(mpc_ilqr_tpu/parallel/sharding.py).

dp is the fleet (data) axis, ls the line-search alpha axis
(parallel/sharded_solve.py). The fleet's leading axis is split over both
axes, rank by rank over the flattened (dp, ls) mesh as the reference's
P(("dp", "ls")) lays it out: every rank owns whole instances, so nothing of
an instance's solve crosses ranks and only the fleet-wide diagnostics (the
mean cost and the solve_ok count) are all-reduced.

A process group must be initialised first, with its address, world size
and rank (`init_process_group(backend, init_method="tcp://localhost:<port>",
world_size=..., rank=...)`): NCCL for "cuda", gloo for "cpu". Without one,
these functions raise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from mpc_ilqr_tpu_torch.costs.params import CostParams
from mpc_ilqr_tpu_torch.costs.references import ReferenceSet
from mpc_ilqr_tpu_torch.ilqr.solver import ILQRConfig
from mpc_ilqr_tpu_torch.models.robot import ARRAY_FIELDS, RobotModel
from mpc_ilqr_tpu_torch.mpc.controller import MPCState
from mpc_ilqr_tpu_torch.parallel import fleet as fleet_mod
from mpc_ilqr_tpu_torch.parallel.sharded_solve import require_group

BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """The ("dp", "ls") mesh over the process group's ranks, the
    reference's split: dp = n and ls = 1 for odd n, else dp = n/2 and
    ls = 2 (or ls = n / dp when dp is given). n must be the world size."""
    require_group("make_mesh")
    n = n_devices or dist.get_world_size()
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks in a world of {dist.get_world_size()}")
    if dist.get_backend() != BACKEND[device_type]:
        raise ValueError(f"a {device_type!r} mesh takes the {BACKEND[device_type]} backend, "
                         f"not {dist.get_backend()}")
    if dp is None:
        dp, ls = (n, 1) if n % 2 else (n // 2, 2)
    else:
        ls = n // dp
    return init_device_mesh(device_type, (dp, ls), mesh_dim_names=("dp", "ls"))


def _block_index(mesh: DeviceMesh):
    """(this rank's block, the number of blocks) over the flattened mesh."""
    dp_i, ls_i = mesh.get_coordinate()
    return dp_i * mesh.shape[1] + ls_i, mesh.shape[0] * mesh.shape[1]


def place_fleet(mesh: DeviceMesh, tree):
    """This rank's block of a fleet-batched tensor, batched RobotModel or
    MPCState (every array split on its leading axis into one block per
    rank, rank by rank)."""
    require_group("place_fleet")
    i, n = _block_index(mesh)

    def block(t):
        if torch.is_tensor(t):
            if t.shape[0] % n:
                raise ValueError(f"fleet axis {t.shape[0]} does not split over {n} ranks")
            per = t.shape[0] // n
            return t[i * per:(i + 1) * per]
        if isinstance(t, RobotModel):
            return t.replace(**{f: block(getattr(t, f)) for f in ARRAY_FIELDS})
        if isinstance(t, MPCState):
            return t.replace(**{f.name: block(getattr(t, f.name)) for f in dataclasses.fields(t)})
        raise TypeError(f"place_fleet: cannot split a {type(t).__name__}")

    return block(tree)


def shard_fleet_step(mesh: DeviceMesh, models: RobotModel, cp: CostParams, cfg: ILQRConfig,
                     refs: ReferenceSet):
    """A fleet MPC step over this rank's block (`models` is the block, as
    place_fleet gives it): step(states, xs) -> (states, u, diagnostics,
    mean_cost, n_ok), the first three this rank's block as
    `fleet.fleet_step_once` gives them, the last two over the whole fleet
    (sums all-reduced over both mesh axes; mean_cost a float64 0-dim
    tensor, n_ok an int64 one)."""
    require_group("shard_fleet_step")

    def step(states: MPCState, xs):
        states2, us, diag = fleet_mod.fleet_step_once(models, cp, cfg, refs, states, xs)
        tot = torch.stack([diag.cost.double().sum(), diag.solve_ok.double().sum(),
                           torch.full((), float(xs.shape[0]), dtype=torch.float64,
                                      device=xs.device)])
        for name in mesh.mesh_dim_names:
            dist.all_reduce(tot, group=mesh.get_group(name))
        return states2, us, diag, tot[0] / tot[2], tot[1].to(torch.int64)

    return step
