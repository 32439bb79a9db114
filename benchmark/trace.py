"""Spans around the program's layers and the reading of the device trace.

`program_spans()` wraps the solver's functions that the fleet step calls in
`torch.profiler.record_function` by rebinding them in their module for the
traced run only; no file of the program changes. `read(events)` reduces a
profiler's events to what the per-layer metrics and the breakdown read:
the traced window, the device's busy time (the union of every device
activity), each span's host time, each kernel's launches and time, and the
device's idle time by the innermost span the host was in.
"""
from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict

import torch
from torch._C._profiler import RecordScope, _ExperimentalConfig
from torch.autograd import (ProfilerActivity, ProfilerConfig, ProfilerState, _disable_profiler,
                            _enable_profiler, _prepare_profiler)
from torch.autograd.profiler import record_function

from mpc_ilqr_tpu_torch.ilqr import solver

# span name -> the solver's attribute it wraps (looked up by name at each call)
PROGRAM_SPANS = {
    "linearize": "linearize",  # engine.step_and_jac under vmap over knots
    "quadraticize": "quadraticize",  # costs.quadratics.quadraticize_gn
    "line_search": "line_search_device",  # masked rollouts of the alphas, their costs
    "backward_k4": "backward_pass_k4",  # ops.riccati (K4), one launch per attempt
    "trajectory_cost": "trajectory_cost",
    "rollout": "rollout",  # the warm start's and the solve's open-loop rollouts
}
HARNESS_SPANS = ("fleet_step", "plant_step")
WINDOW = "window"
LEAVES = tuple(PROGRAM_SPANS) + ("plant_step",)


@contextlib.contextmanager
def program_spans():
    saved = {attr: getattr(solver, attr) for attr in PROGRAM_SPANS.values()}

    def wrap(name, fn):
        def spanned(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return spanned

    try:
        for name, attr in PROGRAM_SPANS.items():
            setattr(solver, attr, wrap(name, saved[attr]))
        yield
    finally:
        for attr, fn in saved.items():
            setattr(solver, attr, fn)


class Profile:
    """torch.profiler's kineto trace of the host's spans only (record_function,
    not every operator: a chunk step dispatches some hundreds of thousands
    of them) and, with cuda, of every device activity. `events` after the
    block."""

    def __init__(self, cuda: bool):
        self.acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda else set())
        self.config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                                     _ExperimentalConfig())
        self.events = None

    def __enter__(self):
        _prepare_profiler(self.config, self.acts)
        _enable_profiler(self.config, self.acts, {RecordScope.USER_SCOPE})
        return self

    def __exit__(self, *exc):
        self.events = _disable_profiler().events()
        return False


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Busy:
    """Disjoint busy intervals with prefix sums: busy time inside [a, b]."""

    def __init__(self, merged):
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]
        self.cum = [0]
        for a, b in merged:
            self.cum.append(self.cum[-1] + b - a)

    def upto(self, t):
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0
        return self.cum[i - 1] + min(t, self.ends[i - 1]) - self.starts[i - 1]

    def within(self, a, b):
        return self.upto(b) - self.upto(a)


def kernel_label(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_:.\-]", "_", name)[:64]


def read(events) -> dict:
    """The trace's summary (seconds), from a profiler's kineto events."""
    names = set(PROGRAM_SPANS) | set(HARNESS_SPANS) | {WINDOW}
    spans, device = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if name not in names:  # a span's shadow on the device's timeline
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        elif name in names:
            spans.append((e.start_ns(), e.end_ns(), name))
    windows = [s for s in spans if s[2] == WINDOW]
    if not windows:
        return {}
    w0, w1 = windows[0][0], windows[0][1]
    inside = [(max(a, w0), min(b, w1), n) for a, b, n in device if b > w0 and a < w1]
    busy = _Busy(_merge([(a, b) for a, b, _ in inside]))
    span_s = defaultdict(float)
    for a, b, n in spans:
        if n != WINDOW:
            span_s[n] += (b - a) * 1e-9
    kernels = defaultdict(lambda: [0, 0.0])
    for a, b, n in inside:
        kernels[n][0] += 1
        kernels[n][1] += (b - a) * 1e-9

    # The window cut into segments, each labelled by the innermost span the
    # host was in; a segment's idle time is its length less its busy time.
    leaves = sorted((a, b, n) for a, b, n in spans if n in LEAVES)
    steps = sorted((a, b) for a, b, n in spans if n == "fleet_step")
    idle = defaultdict(float)
    t, i = w0, 0

    def gap(a, b):  # [a, b] outside every leaf: inside a fleet step or not
        for s0, s1 in steps:
            lo, hi = max(a, s0), min(b, s1)
            if hi > lo:
                idle["fleet_step_other"] += (hi - lo) - busy.within(lo, hi)
        idle["outside_spans"] += (b - a) - busy.within(a, b)

    for a, b, n in leaves:
        a, b = max(a, t), min(b, w1)
        if b <= a:
            continue
        gap(t, a)
        idle[n] += (b - a) - busy.within(a, b)
        t = b
    gap(t, w1)
    # "outside_spans" took every non-leaf stretch; take the fleet steps' share back out
    idle["outside_spans"] -= idle["fleet_step_other"]
    window_s = (w1 - w0) * 1e-9
    return dict(
        window_s=window_s, busy_s=busy.cum[-1] * 1e-9, span_s=dict(span_s),
        kernels={n: (c, s) for n, (c, s) in kernels.items()},
        idle_by_span={n: v * 1e-9 for n, v in idle.items() if v > 0})


def breakdown(summary: dict) -> dict:
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
    gaps = sorted(summary["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[kernel_label(n), s] for n, (_, s) in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
