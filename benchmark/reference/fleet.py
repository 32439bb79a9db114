"""[Frozen copy of mpc_ilqr_tpu_torch/parallel/fleet.py lines 26-37
(randomize) and 68-80 (fleet_step_once, on a config the caller has made
batchable).]

The fleet's domain randomisation and one MPC step of a batch of instances,
`controller.step_once_device` under `torch.func.vmap`.
"""
from __future__ import annotations

import dataclasses

from torch.func import vmap

from . import controller
from .robot import ARRAY_FIELDS, RobotModel

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


def fleet_step_once(models: RobotModel, cp, cfg, refs, states: controller.MPCState, xs):
    """One MPC step of every instance: (states, u (n, nu), diagnostics),
    each with the leading fleet axis. cp and refs are shared."""
    def one(arrays, state, x):
        m = models.replace(**dict(zip(ARRAY_FIELDS, arrays)))
        new, u, diag = controller.step_once_device(
            m, cp, cfg, refs, controller.MPCState(*state), x)
        return tuple(getattr(new, f) for f in STATE_FIELDS), u, tuple(diag)

    state, u, diag = vmap(one)(tuple(getattr(models, f) for f in ARRAY_FIELDS),
                               tuple(getattr(states, f) for f in STATE_FIELDS), xs)
    return controller.MPCState(*state), u, controller.MPCDiagnostics(*diag)
