"""How far a float32 25-step rollout can sit from float64, on the CPU.

    JAX_PLATFORMS=cpu python tools/port_f32_floor.py

For the H1 open-loop chain under gravity-comp controls (N=25, the main
path's K1 input), prints max|a - b| over the whole trajectory for:
  - the JAX package's XLA rollout, float32 vs float64;
  - its Pallas rollout kernel (interpret mode) vs its XLA rollout, float32;
  - the PyTorch port's plain rollout, float32 vs float64;
on two models: the one the reference kernel tests use (load_h1 defaults:
contact stiffness 3e4, damping 3e3, impratio 1) and the main path's
(config.yaml: 5000, 300, impratio 100). The gap between two float32
implementations of the same chain is the floor a kernel-vs-plain tolerance
can ask for; chip_smoke.py's kernel checks are set from it.

Then, for the stiction regime of the main path's model (config.yaml, the
first two steps from standing, chip_smoke.py's inputs for K1, K2 and K3),
the port's plain float32 vs float64 versions, and the same with impratio 1
in the float32 model: what chip_smoke's two-step check at atol 2e-4 leaves
room for, and what a stiction law that ignored impratio would show.
"""
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mpc_ilqr_tpu.dynamics import engine  # noqa: E402
from mpc_ilqr_tpu.ilqr.solver import ILQRConfig, rollout  # noqa: E402
from mpc_ilqr_tpu.models.robot import load_h1, standing_state  # noqa: E402
from mpc_ilqr_tpu.ops.quat_step import build_step_plan  # noqa: E402
from mpc_ilqr_tpu.ops.rollout_kernel import rollout_pallas  # noqa: E402
from mpc_ilqr_tpu_torch import interop  # noqa: E402
from mpc_ilqr_tpu_torch.models.robot import ARRAY_FIELDS, STATIC_FIELDS  # noqa: E402
from mpc_ilqr_tpu_torch.ops.rollout_kernel import rollout_plain  # noqa: E402

N = 25
MODELS = {
    "reference kernel tests (load_h1 defaults)": dict(gravity=(0, 0, -1.0), timestep=0.02),
    "main path (config.yaml contact)": dict(gravity=(0, 0, -1.0), timestep=0.02,
                                            contact_stiffness=5000.0, contact_damping=300.0,
                                            contact_impratio=100.0),
}


def port(jm, dtype):
    d = {f: getattr(jm, f) for f in STATIC_FIELDS}
    d.update({f: np.asarray(getattr(jm, f)) for f in ARRAY_FIELDS})
    return interop.model_from_numpy(d, device="cpu", dtype=dtype)


def main():
    for label, kw in MODELS.items():
        m32, m64 = load_h1(dtype=jnp.float32, **kw), load_h1(dtype=jnp.float64, **kw)
        x0 = standing_state(m32)
        us = jnp.tile(engine.gravity_comp(m32, x0)[None], (N, 1))
        cfg = ILQRConfig(N=N)
        xla32 = np.asarray(jax.jit(lambda x, u: rollout(m32, cfg, x, u))(x0, us))
        xla64 = np.asarray(jax.jit(lambda x, u: rollout(m64, cfg, x, u))(
            x0.astype(jnp.float64), us.astype(jnp.float64)))
        pallas = np.asarray(rollout_pallas(m32, build_step_plan(m32), x0, us, interpret=True))
        t32 = rollout_plain(port(m32, torch.float32), torch.tensor(np.asarray(x0)),
                            torch.tensor(np.asarray(us))).numpy()
        t64 = rollout_plain(port(m64, torch.float64), torch.tensor(np.asarray(x0), dtype=torch.float64),
                            torch.tensor(np.asarray(us), dtype=torch.float64)).numpy()
        print(f"{label}:")
        print(f"  JAX XLA f32 vs f64:            {np.abs(xla32 - xla64).max():.3e}")
        print(f"  JAX Pallas (interpret) vs XLA: {np.abs(pallas - xla32).max():.3e}")
        print(f"  port plain f32 vs f64:         {np.abs(t32 - t64).max():.3e}")
        print(f"  port plain f64 vs JAX f64:     {np.abs(t64 - xla64).max():.3e}")
    stiction()


def stiction(n=2):
    from mpc_ilqr_tpu_torch.dynamics import engine as tengine
    from mpc_ilqr_tpu_torch.io.config import load_config
    from mpc_ilqr_tpu_torch.models.robot import standing_state as t_standing
    from mpc_ilqr_tpu_torch.mpc import runner
    from mpc_ilqr_tpu_torch.ops import rollout_kernel as rk

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    app = load_config(os.path.join(root, "config.yaml"))
    app.q_ref_path = "data/q_standing.csv"
    app.v_ref_path = "data/v_standing.csv"
    app.contact_schedule_path = "data/contact_standing.csv"
    prob = runner.setup(app, device="cpu")
    m = prob.model
    rng = np.random.default_rng(0)  # chip_smoke.py's kernel_cases
    t32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    x0 = t_standing(m)
    ug = tengine.gravity_comp(m, x0)
    ubar = ug[None] + t32(0.1 * rng.normal(0, 1, (n, m.nu)))
    xbar = rk.rollout_plain(m, x0, ubar)
    K = t32(0.01 * rng.normal(0, 1, (n, m.nu, m.nx)))
    kff = t32(0.1 * rng.normal(0, 1, (n, m.nu)))
    alphas = torch.tensor(prob.cfg.alphas, dtype=torch.float32)
    cases = {
        "K1": lambda mm, dt: (rk.rollout_plain(mm, x0.to(dt), ug[None].repeat(n, 1).to(dt)),),
        "K2": lambda mm, dt: rk.linesearch_rollout_plain(
            mm, *[t.to(dt) for t in (x0, xbar, ubar, K, kff, alphas[:1])]),
        "K3": lambda mm, dt: rk.linesearch_rollout_batched_plain(
            mm, *[t.to(dt) for t in (x0, xbar, ubar, K, kff, alphas[1:])]),
    }
    m64 = m.to(dtype=torch.float64)
    m_imp1 = m.replace(contact_impratio=torch.tensor(1.0))
    err = lambda a, b: max(float((p.double() - q).abs().max()) for p, q in zip(a, b))
    print(f"main path, {n} steps from standing (impratio {float(m.contact_impratio)}):")
    for name, f in cases.items():
        want = f(m64, torch.float64)
        print(f"  {name} port plain f32 vs f64: {err(f(m, torch.float32), want):.3e}; "
              f"with impratio 1 in f32: {err(f(m_imp1, torch.float32), want):.3e}")


if __name__ == "__main__":
    main()
