"""MuJoCo in the loop: the port's controller, MuJoCo's physics as the plant
(mpc_ilqr_tpu/mpc/mujoco_plant.py).

The controller plans with the differentiable engine on the problem's device
(the rollout kernels through its StepPlan on the card, their plain versions
on the CPU); the plant is a MuJoCo simulation with the reference's solver
settings (elliptic cone, Newton, 500 iterations, tolerance 1e-8, impratio;
robot_utils.cpp:58-63, 588-592). If H1 stays standing on it, the compliant
internal model is close enough to control MuJoCo's contact.

mujoco is optional and imported only when a plant is built: importing this
module never imports it, so the module loads where mujoco is not installed
(as on a GPU host with only the port's requirements), and building a plant
there raises an ImportError that names mujoco.
"""
from __future__ import annotations

import numpy as np
import torch

from mpc_ilqr_tpu_torch.models.robot import standing_state
from mpc_ilqr_tpu_torch.mpc import controller


def import_mujoco():
    """The mujoco module, or an ImportError that names it."""
    try:
        import mujoco
    except ImportError as e:
        raise ImportError("the MuJoCo plant (--plant mujoco) needs the mujoco package, which "
                          "is not installed here") from e
    return mujoco


class MuJoCoPlant:
    """A MuJoCo model and its data with the reference's solver settings:
    set_state / get_state / step like RobotUtils."""

    def __init__(self, xml_path: str, gravity, timestep: float, impratio: float = 100.0):
        mujoco = self._mj = import_mujoco()
        self.m = mujoco.MjModel.from_xml_path(xml_path)
        self.m.opt.gravity[:] = gravity
        self.m.opt.timestep = timestep
        self.m.opt.impratio = impratio
        # Reference solver tuning (robot_utils.cpp:588-592)
        self.m.opt.cone = mujoco.mjtCone.mjCONE_ELLIPTIC
        self.m.opt.jacobian = mujoco.mjtJacobian.mjJAC_SPARSE
        self.m.opt.solver = mujoco.mjtSolver.mjSOL_NEWTON
        self.m.opt.iterations = 500
        self.m.opt.tolerance = 1e-8
        self.d = mujoco.MjData(self.m)

    def set_state(self, x: np.ndarray):
        self.d.qpos[:] = x[: self.m.nq]
        self.d.qvel[:] = x[self.m.nq:]
        self._mj.mj_forward(self.m, self.d)

    def get_state(self) -> np.ndarray:
        return np.concatenate([np.asarray(self.d.qpos), np.asarray(self.d.qvel)])

    def step(self, u: np.ndarray, n_substeps: int = 1) -> np.ndarray:
        self.d.ctrl[:] = np.asarray(u)
        for _ in range(n_substeps):
            self._mj.mj_step(self.m, self.d)
        return self.get_state()


def run_mujoco_in_the_loop(prob, n_steps: int, x0=None, verbose: bool = False) -> dict:
    """Closed loop of `controller.step_once` (on the problem's device) and
    the MuJoCo plant, dt / physics_dt plant substeps per control step; a
    non-finite control is applied as zeros. Returns the history: per step
    the plant's state after it ("x", float64 numpy), the control ("u") and
    the solve's cost ("cost", a float)."""
    model, cp, cfg, refs, app = prob.model, prob.cp, prob.cfg, prob.refs, prob.app
    plant = MuJoCoPlant(app.resolve(app.model_path), gravity=app.mpc.gravity,
                        timestep=app.mpc.physics_dt, impratio=app.mpc.contact_impratio)
    x = standing_state(model) if x0 is None else x0
    x = (x.detach().cpu().double().numpy() if torch.is_tensor(x)
         else np.asarray(x, dtype=np.float64))
    plant.set_state(x)
    substeps = max(1, round(app.mpc.dt / app.mpc.physics_dt))
    state = controller.init_state(model, cfg)

    hist = {"x": [], "u": [], "cost": []}
    for i in range(n_steps):
        xt = torch.as_tensor(x, dtype=model.dtype, device=model.device)
        state, u, diag = controller.step_once(model, cp, cfg, refs, state, xt, plan=prob.plan)
        u_np = u.detach().cpu().double().numpy()
        if not np.isfinite(u_np).all():
            u_np = np.zeros_like(u_np)
        x = plant.step(u_np, substeps)
        hist["x"].append(x.copy())
        hist["u"].append(u_np)
        hist["cost"].append(float(diag.cost))
        if verbose:
            print(f"[mj-loop] step {i}: cost {float(diag.cost):.4f} base z {x[2]:.4f} "
                  f"quat w {x[3]:.4f}")
    return hist
