"""Fleet MPC: many domain-randomised H1 instances in lockstep
(mpc_ilqr_tpu/parallel/fleet.py).

A batched model is a RobotModel whose ARRAY_FIELDS carry a leading fleet
axis; the static structure is shared. Fleet states are MPCStates of
tensors (t_idx, has_prev included) with the same leading axis. One fleet
step is `controller.step_once_device` under `torch.func.vmap` over the
instances, with the config batched_config makes of it (vmap_safe, the plain
chains: no StepPlan, as the reference's fleet takes none).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.func import vmap

from mpc_ilqr_tpu_torch.costs.params import CostParams
from mpc_ilqr_tpu_torch.costs.references import ReferenceSet
from mpc_ilqr_tpu_torch.ilqr import solver as ilqr
from mpc_ilqr_tpu_torch.models.robot import ARRAY_FIELDS, RobotModel
from mpc_ilqr_tpu_torch.mpc import controller

STATE_FIELDS = tuple(f.name for f in dataclasses.fields(controller.MPCState))


def randomize(model: RobotModel, mass_scale, friction, stiff_mult) -> RobotModel:
    """The batched model of the draws (each (n,)): masses and inertias
    scaled per instance (scaleRobotMass), contact friction and stiffness
    multiplied; every other array tiled."""
    n = mass_scale.shape[0]
    arrays = {f: getattr(model, f).expand((n,) + getattr(model, f).shape) for f in ARRAY_FIELDS}
    arrays.update(body_mass=model.body_mass[None, :] * mass_scale[:, None],
                  body_inertia=model.body_inertia[None, :, :] * mass_scale[:, None, None],
                  contact_friction=model.contact_friction * friction,
                  contact_stiffness=model.contact_stiffness * stiff_mult)
    return model.replace(**arrays)


def randomized_models(model: RobotModel, generator: torch.Generator, n: int,
                      mass_scale_range=(0.8, 1.2), friction_range=(0.7, 1.3),
                      stiffness_jitter=0.2) -> RobotModel:
    """n instances of `model` with uniform draws from `generator` (mass
    scale, friction, stiffness multiplier 1 ± jitter, in that order; the
    reference's ranges)."""
    def uniform(lo, hi):
        u = torch.rand(n, generator=generator, dtype=model.dtype, device=generator.device)
        return (lo + (hi - lo) * u).to(model.device)

    mass_scale = uniform(*mass_scale_range)
    friction = uniform(*friction_range)
    stiff_mult = 1.0 + stiffness_jitter * uniform(-1.0, 1.0)
    return randomize(model, mass_scale, friction, stiff_mult)


def fleet_init(models: RobotModel, cfg: ilqr.ILQRConfig, n: int) -> controller.MPCState:
    """n empty carries of tensors (init_state(..., tensors=True) tiled)."""
    state = controller.init_state(models, cfg, tensors=True)
    return controller.MPCState(**{f: getattr(state, f).expand((n,) + getattr(state, f).shape)
                                  .clone() for f in STATE_FIELDS})


def fleet_step_once(models: RobotModel, cp: CostParams, cfg: ilqr.ILQRConfig,
                    refs: ReferenceSet, states: controller.MPCState, xs):
    """One MPC step of every instance: (states, u (n, nu), diagnostics),
    each with the leading fleet axis. cp and refs are shared. The config
    becomes ilqr.batched_config(cfg): first_accept, the fixed-trip outer
    loop, rollout_backend and ls_backend "xla" (no StepPlan)."""
    cfg = ilqr.batched_config(cfg)

    def one(arrays, state, x):
        m = models.replace(**dict(zip(ARRAY_FIELDS, arrays)))
        new, u, diag = controller.step_once_device(
            m, cp, cfg, refs, controller.MPCState(*state), x)
        return tuple(getattr(new, f) for f in STATE_FIELDS), u, tuple(diag)

    state, u, diag = vmap(one)(tuple(getattr(models, f) for f in ARRAY_FIELDS),
                               tuple(getattr(states, f) for f in STATE_FIELDS), xs)
    return controller.MPCState(*state), u, controller.MPCDiagnostics(*diag)


def fleet_step_chunked(models: RobotModel, cp: CostParams, cfg: ilqr.ILQRConfig,
                       refs: ReferenceSet, states: controller.MPCState, xs, chunk: int):
    """`fleet_step_once` over chunks of `chunk` instances, one after the
    other: the vmapped linearization holds its tangents for a whole chunk
    at once, so the chunk bounds the memory. Same result as one call."""
    n = xs.shape[0]
    if n % chunk:
        raise ValueError(f"fleet size {n} is not divisible by chunk {chunk}")
    outs = []
    for i in range(0, n, chunk):
        part = lambda t: t[i:i + chunk]
        m = models.replace(**{f: part(getattr(models, f)) for f in ARRAY_FIELDS})
        s = controller.MPCState(**{f: part(getattr(states, f)) for f in STATE_FIELDS})
        outs.append(fleet_step_once(m, cp, cfg, refs, s, part(xs)))
    cat = lambda ts: torch.cat(ts, dim=0)
    state = controller.MPCState(**{f: cat([getattr(o[0], f) for o in outs]) for f in STATE_FIELDS})
    diag = controller.MPCDiagnostics(*(cat(list(t)) for t in zip(*(o[2] for o in outs))))
    return state, cat([o[1] for o in outs]), diag
