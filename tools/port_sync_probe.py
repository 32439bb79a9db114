"""Where the port's building blocks wait for the card, and how the vmapped
ones scale: run on a machine with the GPU.

    python3 tools/port_sync_probe.py

On the standing flagship (config.yaml, standing references, float32) it
runs gravity_comp, one dynamics step, a plain N=25 rollout, the reference
window, linearize, quadraticize_gn, the trajectory cost and the backward
pass, then the same parts under torch.func.vmap over a batched model of 4
instances, each under torch.cuda.set_sync_debug_mode("warn"), and prints
every host sync (and any vmap fallback to a per-example loop) by the three
innermost frames of this repository that led to it. Then it times the
vmapped linearize, quadraticize_gn and rollout at 32 and 128 instances
(N=25) with their peak memory.
"""
import collections
import dataclasses
import os
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.func import vmap  # noqa: E402

from mpc_ilqr_tpu_torch.costs.quadratics import quadraticize_gn, trajectory_cost  # noqa: E402
from mpc_ilqr_tpu_torch.costs.references import extract_window  # noqa: E402
from mpc_ilqr_tpu_torch.dynamics import engine  # noqa: E402
from mpc_ilqr_tpu_torch.ilqr import solver  # noqa: E402
from mpc_ilqr_tpu_torch.io.config import load_config  # noqa: E402
from mpc_ilqr_tpu_torch.models.robot import ARRAY_FIELDS, standing_state  # noqa: E402
from mpc_ilqr_tpu_torch.mpc import runner  # noqa: E402
from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk  # noqa: E402

SITES = collections.Counter()


def record(message, category, filename, lineno, file=None, line=None):
    stack = [f for f in traceback.extract_stack()
             if f.filename.startswith(ROOT) and not f.filename.endswith("port_sync_probe.py")]
    key = " <- ".join(f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}" for f in reversed(stack[-3:]))
    SITES[(str(message)[:70].replace("\n", " "), key)] += 1


def section(name, fn):
    SITES.clear()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    t0 = time.perf_counter()
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"[{name}] {(time.perf_counter() - t0) * 1e3:.1f} ms, {sum(SITES.values())} warnings "
          f"at {len(SITES)} sites")
    for (msg, key), n in sorted(SITES.items(), key=lambda kv: -kv[1]):
        print(f"    {n:6d}  {msg} | {key}")


def main():
    warnings.showwarning = record
    warnings.simplefilter("always")
    app = load_config(os.path.join(ROOT, "config.yaml"))
    app.q_ref_path, app.v_ref_path, app.contact_schedule_path = (
        "data/q_standing.csv", "data/v_standing.csv", "data/contact_standing.csv")
    prob = runner.setup(app)
    m, cp, refs = prob.model, prob.cp, prob.refs
    cfg = dataclasses.replace(prob.cfg, rollout_backend="xla", ls_backend="xla",
                              line_search="first_accept")
    print(torch.cuda.get_device_name(0), torch.__version__)
    x = standing_state(m)
    u = engine.gravity_comp(m, x)
    N = cfg.N
    us = u[None].repeat(N, 1).contiguous()
    xs = rk.rollout_plain(m, x, us)
    win = extract_window(refs, 0, N)
    A, B = solver.linearize(m, cfg, xs, us)
    q = quadraticize_gn(m, cp, win, xs, us)
    reg = torch.full((), 1e-6, device="cuda")

    section("gravity_comp", lambda: engine.gravity_comp(m, x))
    section("step", lambda: engine.step(m, x, u))
    section("rollout_plain N=25", lambda: rk.rollout_plain(m, x, us))
    section("extract_window", lambda: extract_window(refs, 3, N))
    section("linearize N=25", lambda: solver.linearize(m, cfg, xs, us))
    section("quadraticize", lambda: quadraticize_gn(m, cp, win, xs, us))
    section("trajectory_cost", lambda: trajectory_cost(m, cp, win, xs, us))
    section("backward_pass", lambda: solver.backward_pass(A, B, q, reg, 1e-4))

    def batched(nb):
        arrays = tuple(getattr(m, f)[None].expand((nb,) + getattr(m, f).shape).contiguous()
                       for f in ARRAY_FIELDS)
        return arrays, xs[None].repeat(nb, 1, 1), us[None].repeat(nb, 1, 1)

    at = lambda a: dataclasses.replace(m, **dict(zip(ARRAY_FIELDS, a)))
    arrays, xsb, usb = batched(4)
    section("vmap step (model batched)", lambda: vmap(lambda a, x_, u_: engine.step(at(a), x_, u_))(
        arrays, xsb[:, 0], usb[:, 0]))
    section("vmap linearize (model batched)", lambda: vmap(
        lambda a, x_, u_: solver.linearize(at(a), cfg, x_, u_))(arrays, xsb, usb))
    section("vmap quadraticize", lambda: vmap(
        lambda x_, u_: quadraticize_gn(m, cp, win, x_, u_))(xsb, usb))
    section("vmap traj cost", lambda: vmap(
        lambda x_, u_: trajectory_cost(m, cp, win, x_, u_))(xsb, usb))

    for nb in (32, 128):
        arrays, xsb, usb = batched(nb)
        parts = {
            "linearize": lambda: vmap(lambda a, x_, u_: solver.linearize(at(a), cfg, x_, u_))(
                arrays, xsb, usb),
            "quadraticize": lambda: vmap(lambda x_, u_: quadraticize_gn(m, cp, win, x_, u_))(
                xsb, usb),
            "rollout": lambda: vmap(lambda a, u_: rk.rollout_plain(at(a), x, u_))(arrays, usb),
        }
        for name, f in parts.items():
            f()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            f()
            torch.cuda.synchronize()
            print(f"scale nb={nb} {name}: {(time.perf_counter() - t0) * 1e3:.1f} ms, peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


if __name__ == "__main__":
    main()
