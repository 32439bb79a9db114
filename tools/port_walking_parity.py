"""How far the port's run_simulation sits from the JAX package's on the
walking config, in float32 and in float64, on the CPU.

    JAX_PLATFORMS=cpu python tools/port_walking_parity.py

Both packages run config.yaml as shipped (the walking references and
contact schedule) with the solver cut to tests/test_torch_runner.py's size
(N=6, max_iterations=3, 3 sim steps), once with the engine in float32 (the
shipped dtype) and once in float64. Prints, per sim step, the iterations and
solve_ok of both, max|x_port - x_jax|, max|u_port - u_jax| and the cost's
relative gap. The float64 gaps say whether the two compute the same thing;
the float32 gaps are the round-off floor that the test's float32 bars are
set from.
"""
import dataclasses
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mpc_ilqr_tpu.io.config import load_config as j_load_config  # noqa: E402
from mpc_ilqr_tpu.mpc import runner as jrunner  # noqa: E402
from mpc_ilqr_tpu_torch.io.config import load_config  # noqa: E402
from mpc_ilqr_tpu_torch.mpc import runner as trunner  # noqa: E402

SMALL = dict(N=6, max_iterations=3)
STEPS = 3


def run(side, dtype):
    """(hist, solve_ok per step) of one package's run_simulation."""
    if side == "jax":
        app = j_load_config(os.path.join(ROOT, "config.yaml"))
        app.engine["dtype"] = dtype
        prob = jrunner.setup(app)
        mod, run_sim = jax, jrunner.run_simulation
    else:
        app = load_config(os.path.join(ROOT, "config.yaml"))
        app.engine["dtype"] = dtype
        prob = trunner.setup(app, device="cpu")
        mod, run_sim = trunner, trunner.run_simulation
    prob = prob._replace(cfg=dataclasses.replace(prob.cfg, **SMALL))
    oks, inner = [], mod.block_until_ready

    def recording(out):  # each step's solve_ok passes through this wait
        out = inner(out)
        if isinstance(out, tuple) and len(out) == 3 and hasattr(out[2], "solve_ok"):
            oks.append(bool(out[2].solve_ok))
        return out
    mod.block_until_ready = recording
    try:
        hist, _ = run_sim(prob, sim_steps=STEPS, verbose=False)
    finally:
        mod.block_until_ready = inner
    return hist, oks


def main():
    for dtype in ("float32", "float64"):
        (jh, jok), (th, tok) = run("jax", dtype), run("port", dtype)
        print(f"walking, N={SMALL['N']}, max_iterations={SMALL['max_iterations']}, {dtype}:")
        for i in range(STEPS):
            dx = float(np.abs(th["x"][i].astype(np.float64) - jh["x"][i]).max())
            du = float(np.abs(th["u"][i].astype(np.float64) - jh["u"][i]).max())
            dc = abs(th["cost"][i] - jh["cost"][i]) / abs(jh["cost"][i])
            print(f"  step {i}: iterations {th['iterations'][i]} / {jh['iterations'][i]}, "
                  f"solve_ok {tok[i]} / {jok[i]}, max|dx| {dx:.3e}, max|du| {du:.3e} "
                  f"(max|u| {float(np.abs(jh['u'][i]).max()):.3f}), cost rel {dc:.3e} "
                  f"(cost {jh['cost'][i]:.4f})")


if __name__ == "__main__":
    main()
