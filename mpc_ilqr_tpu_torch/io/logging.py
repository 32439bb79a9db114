"""CSV logs with the reference's headers (mpc.cpp:181-343).

- step log: time_index,time_sec,solve_cost,solve_time_ms,x_*,u_*,x_ref_*,u_ref_*
- q_optimal.csv: step,time_sec,q_0..q_{nq-1}   (read by tools/simulate.py, plotter.py)
- u_optimal.csv: step,time_sec,u_0..u_{nu-1}

Rows match the JAX package's `io/logging.py` byte for byte. Each `log` takes
torch tensors or numpy arrays; tensors are joined on their device and moved
to the host in one copy per row. The step log rides the native async writer
(io/native.py), so logging never blocks the control loop.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from mpc_ilqr_tpu_torch.io.native import AsyncTelemetry


def _host(parts, dtype=None):
    """The parts (tensors, arrays or scalars) as 1-D numpy arrays, with one
    device-to-host copy for all the tensors among them. dtype None keeps each
    part's own dtype (the tensors must then share theirs)."""
    tensors = [p for p in parts if torch.is_tensor(p)]
    if not tensors:
        return [np.asarray(p, dtype=dtype).ravel() for p in parts]
    dev = tensors[0].device
    flat = [torch.as_tensor(p if torch.is_tensor(p) else np.asarray(p), device=dev)
            .to(dtype=torch.float64 if dtype is not None else tensors[0].dtype).reshape(-1)
            for p in parts]
    joined = torch.cat(flat).cpu().numpy()
    return np.split(joined, np.cumsum([f.numel() for f in flat])[:-1])


class StepLogger:
    """MPC::enableCSVLogging / logCurrentStep (async, non-blocking)."""

    def __init__(self, path: str, nx: int, nu: int):
        cols = ["time_index", "time_sec", "solve_cost", "solve_time_ms"]
        cols += [f"x_{i}" for i in range(nx)]
        cols += [f"u_{i}" for i in range(nu)]
        cols += [f"x_ref_{i}" for i in range(nx)]
        cols += [f"u_ref_{i}" for i in range(nu)]
        self.header = ",".join(cols)
        self._telem = AsyncTelemetry(path, self.header)

    @property
    def native(self) -> bool:
        """True when the native background writer takes the rows."""
        return self._telem.native

    @property
    def dropped(self) -> int:
        return self._telem.dropped

    def log(self, t_idx: int, dt: float, cost, solve_ms: float, x, u, x_ref, u_ref) -> None:
        head = [t_idx, t_idx * dt]
        parts = _host([cost, solve_ms, x, u, x_ref, u_ref], dtype=np.float64)
        self._telem.log(np.concatenate([np.array(head, dtype=np.float64), *parts]))

    def close(self) -> None:
        self._telem.close()


class OptimalTrajectoryLogger:
    """MPC::enableOptimalTrajectoryLogging / logAppliedOptimal."""

    def __init__(self, base_path: str, nq: int, nu: int):
        os.makedirs(base_path, exist_ok=True)
        self.qf = open(os.path.join(base_path, "q_optimal.csv"), "w")
        self.uf = open(os.path.join(base_path, "u_optimal.csv"), "w")
        self.qf.write("step,time_sec," + ",".join(f"q_{i}" for i in range(nq)) + "\n")
        self.uf.write("step,time_sec," + ",".join(f"u_{i}" for i in range(nu)) + "\n")

    def log(self, t_idx: int, dt: float, q_opt, u_opt) -> None:
        q_opt, u_opt = _host([q_opt, u_opt])  # values keep their dtype: str() prints it
        self.qf.write(f"{t_idx},{t_idx * dt}," + ",".join(str(v) for v in q_opt) + "\n")
        self.uf.write(f"{t_idx},{t_idx * dt}," + ",".join(str(v) for v in u_opt) + "\n")

    def close(self) -> None:
        for f in (self.qf, self.uf):
            f.flush()
            f.close()
