"""Named-stage wall-clock profiler with the reference's stage names and table.

The reference brackets stages with steady_clock pushes into a global map and
prints a Calls/Total/Avg/Min/Max table at exit (humanoid_mpc.cpp:22-49,
195-226); RSS comes from /proc/self/status as in its memory profiler. A
stage ends with `torch.cuda.synchronize` on each CUDA device its output
lives on, so asynchronous launches are not under-timed; CPU outputs need no
wait. Once CUDA is in use, the memory summary gains one line: the card's
peak allocation (`torch.cuda.max_memory_allocated`), labelled as the card's.

Stage names, as in the reference: MPC_stepOnce, MPC_extractReference,
MPC_warmStart, MPC_iLQR_solve, MPC_computeControl, iLQR_forwardRollout,
iLQR_linearization, iLQR_costQuadratics, iLQR_backwardPass,
iLQR_lineSearch, iLQR_computeCost.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Dict, List

import torch


def _rss_mb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of every tensor in a nest of tuples, lists, dicts and
    dataclasses."""
    if torch.is_tensor(out):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _cuda_devices(o, found)
    elif isinstance(out, dict):
        for o in out.values():
            _cuda_devices(o, found)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            _cuda_devices(getattr(out, f.name), found)
    return found


def block_until_ready(out):
    """Wait for the devices that hold `out`'s tensors; return `out`."""
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)
    return out


class Profiler:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.times: Dict[str, List[float]] = defaultdict(list)
        self.mem_initial = _rss_mb()
        self.mem_peak = self.mem_initial

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """Time a stage; pass the stage's output via `block_on` so that
        asynchronous launches are waited for."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            block_until_ready(block_on)
        self.times[name].append((time.perf_counter() - t0) * 1e3)
        self.mem_peak = max(self.mem_peak, _rss_mb())

    def record(self, name: str, ms: float):
        self.times[name].append(ms)

    def time_fn(self, name: str, fn, *args, **kw):
        t0 = time.perf_counter()
        out = block_until_ready(fn(*args, **kw))
        self.times[name].append((time.perf_counter() - t0) * 1e3)
        self.mem_peak = max(self.mem_peak, _rss_mb())
        return out

    def report(self) -> str:
        lines = ["", "=== Performance Profiling ===", "", "--- Timing Summary ---"]
        lines.append(
            f"{'Function':<22}{'Calls':>8}{'Total(ms)':>12}{'Avg(ms)':>12}{'Min(ms)':>12}{'Max(ms)':>12}"
        )
        lines.append("-" * 78)
        for name in sorted(self.times):
            ts = self.times[name]
            lines.append(
                f"{name:<22}{len(ts):>8}{sum(ts):>12.2f}{sum(ts)/len(ts):>12.2f}"
                f"{min(ts):>12.2f}{max(ts):>12.2f}"
            )
        mem_final = _rss_mb()
        lines += [
            "",
            "--- Memory Summary ---",
            f"Initial:  {self.mem_initial:.2f} MB",
            f"Peak:     {self.mem_peak:.2f} MB",
            f"Final:    {mem_final:.2f} MB",
        ]
        if torch.cuda.is_initialized():
            lines.append(f"Card peak allocated ({torch.cuda.get_device_name()}, "
                         f"max_memory_allocated): {torch.cuda.max_memory_allocated() / 2**20:.2f} MB")
        lines.append("==========================")
        return "\n".join(lines)
