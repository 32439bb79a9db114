"""The three rollout entry points, their plain versions and launch counts.

    rollout_kernel                      K1, TPU rollout_pallas
    linesearch_rollout_kernel           K2, TPU linesearch_rollout_pallas
    linesearch_rollout_kernel_batched   K3, TPU linesearch_rollout_pallas_batched

On a CUDA tensor each entry point launches its kernel (csrc/rollout.cu) on
the current stream, checks the launch, counts it in LAUNCHES and never
synchronises; it raises on anything the kernel does not take (float32 only,
as on the TPU). On a CPU tensor it runs its plain version: a Python loop over
`engine.step` with the same feedback law. K2 and K3 share one CUDA kernel
(one block per alpha) and its alpha-major output; the batched TPU
kernel's time-major layout was internal to it and is not kept.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from mpc_ilqr_tpu_torch.dynamics import engine
from mpc_ilqr_tpu_torch.models.robot import RobotModel
from mpc_ilqr_tpu_torch.ops import _build
from mpc_ilqr_tpu_torch.ops.step_plan import StepPlan

LAUNCHES = {"rollout": 0, "linesearch": 0, "linesearch_batched": 0}
CUDA_KERNEL = {"rollout": "rollout_open", "linesearch": "rollout_feedback",
               "linesearch_batched": "rollout_feedback"}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---- plain versions ---------------------------------------------------------

def rollout_plain(model: RobotModel, x0, us, n_substeps: int = 1, solver: str = "chol"):
    """xs (N+1, nx): x_{t+1} = step(x_t, u_t) (`solver`: engine.step's)."""
    xs = [x0]
    for t in range(us.shape[0]):
        xs.append(engine.step(model, xs[-1], us[t], n_substeps, solver=solver))
    return torch.stack(xs)


def linesearch_rollout_plain(model: RobotModel, x0, xbar, ubar, K, kff, alphas,
                             n_substeps: int = 1):
    """Per alpha, the closed-loop chain: xs (A, N+1, nx), us (A, N, nu)."""
    xs_all, us_all = [], []
    for alpha in alphas:
        x, xs, us = x0, [x0], []
        for t in range(ubar.shape[0]):
            u = ubar[t] + alpha * kff[t] + torch.matmul(K[t], x - xbar[t])
            x = engine.step(model, x, u, n_substeps)
            xs.append(x)
            us.append(u)
        xs_all.append(torch.stack(xs))
        us_all.append(torch.stack(us))
    return torch.stack(xs_all), torch.stack(us_all)


def linesearch_rollout_batched_plain(model: RobotModel, x0, xbar, ubar, K, kff, alphas,
                                     n_substeps: int = 1, solver: str = "chol"):
    """All alphas advanced together, one batched step per t."""
    step_b = vmap(lambda x, u: engine.step(model, x, u, n_substeps, solver=solver))
    x = x0[None].expand(alphas.shape[0], -1)
    xs, us = [x], []
    for t in range(ubar.shape[0]):
        u = ubar[t][None] + alphas[:, None] * kff[t][None] + torch.matmul(
            x - xbar[t][None], K[t].T)
        x = step_b(x, u)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=1), torch.stack(us, dim=1)


# ---- kernels ------------------------------------------------------------------

def _on_card(plan: StepPlan, *tensors, shapes) -> bool:
    """True for CUDA inputs (checked for the kernel), False for CPU inputs."""
    dev = tensors[0].device
    if dev.type == "cpu" and all(t.device.type == "cpu" for t in tensors):
        return False
    if dev.type != "cuda":
        raise ValueError(f"rollout kernels take CUDA or CPU tensors, got {dev}")
    if plan is None:
        raise ValueError("a StepPlan (ops.step_plan.build_step_plan) is required on CUDA")
    for t, shape in zip(tensors, shapes):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"rollout kernels take contiguous float32 tensors on one CUDA "
                             f"device, got {t.dtype} {t.device} contiguous={t.is_contiguous()}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"rollout kernel input shape {tuple(t.shape)}, expected {shape}")
    if plan.fbuf.device != dev:
        raise ValueError(f"StepPlan lives on {plan.fbuf.device}, inputs on {dev}")
    return True


def _model_args(plan: StepPlan):
    return (plan.fbuf.data_ptr(), plan.ibuf.data_ptr(), plan.fbuf.numel(), plan.ibuf.numel(),
            plan.B, plan.nq, plan.nv, plan.nu, plan.ncp)


def _check(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"{lib.mpc_error_string(rc).decode()} (error {rc})")


def rollout_kernel(model: RobotModel, plan: StepPlan, x0, us, n_substeps: int = 1):
    """K1 — open-loop chain: xs (N+1, nx)."""
    N = us.shape[0]
    if not _on_card(plan, x0, us, shapes=[(model.nx,), (N, model.nu)]):
        return rollout_plain(model, x0, us, n_substeps)
    lib = _build.library()
    xs = torch.empty((N + 1, model.nx), dtype=torch.float32, device=x0.device)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    rc = lib.mpc_rollout_open(*_model_args(plan), x0.data_ptr(), us.data_ptr(), xs.data_ptr(),
                              N, n_substeps, model.timestep / n_substeps, stream)
    _check(lib, rc, "rollout_open")
    LAUNCHES["rollout"] += 1
    return xs


def _feedback_launch(model, plan, x0, xbar, ubar, K, kff, alphas, n_substeps):
    A, N = alphas.shape[0], ubar.shape[0]
    lib = _build.library()
    xs = torch.empty((A, N + 1, model.nx), dtype=torch.float32, device=x0.device)
    us = torch.empty((A, N, model.nu), dtype=torch.float32, device=x0.device)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    rc = lib.mpc_rollout_feedback(
        *_model_args(plan), x0.data_ptr(), xbar.data_ptr(), ubar.data_ptr(), K.data_ptr(),
        kff.data_ptr(), alphas.data_ptr(), A, xs.data_ptr(), us.data_ptr(), N, n_substeps,
        model.timestep / n_substeps, stream)
    _check(lib, rc, "rollout_feedback")
    return xs, us


def _ls_shapes(model, ubar, alphas):
    N, nx, nu = ubar.shape[0], model.nx, model.nu
    return [(nx,), (N + 1, nx), (N, nu), (N, nu, nx), (N, nu), (alphas.shape[0],)]


def linesearch_rollout_kernel(model: RobotModel, plan: StepPlan, x0, xbar, ubar, K, kff,
                              alphas, n_substeps: int = 1):
    """K2 — closed-loop chains, one per alpha: xs (A, N+1, nx), us (A, N, nu)."""
    args = (x0, xbar, ubar, K, kff, alphas)
    if not _on_card(plan, *args, shapes=_ls_shapes(model, ubar, alphas)):
        return linesearch_rollout_plain(model, *args, n_substeps)
    out = _feedback_launch(model, plan, *args, n_substeps)
    LAUNCHES["linesearch"] += 1
    return out


def linesearch_rollout_kernel_batched(model: RobotModel, plan: StepPlan, x0, xbar, ubar, K,
                                      kff, alphas, n_substeps: int = 1):
    """K3 — the same contract with all alphas in one launch:
    xs (A, N+1, nx), us (A, N, nu)."""
    args = (x0, xbar, ubar, K, kff, alphas)
    if not _on_card(plan, *args, shapes=_ls_shapes(model, ubar, alphas)):
        return linesearch_rollout_batched_plain(model, *args, n_substeps)
    out = _feedback_launch(model, plan, *args, n_substeps)
    LAUNCHES["linesearch_batched"] += 1
    return out
