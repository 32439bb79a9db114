"""The JAX package's own float32 `backward_pass_assoc` against a float64
serial pass, on the long-horizon path's Riccati inputs, on the CPU: the
anchor of chip_smoke.py phase 10 (c)'s float32 reading (ASSOC_ANCHOR).

    JAX_PLATFORMS=cpu python tools/assoc_anchor.py

The inputs are chip_smoke.long_horizon_inputs made by the port on the CPU
(H1, N=100, dt 0.01: A, B and the GN quadratics of window 0 along the
cold-start rollout from standing, float32), the inputs phase 5 and phase
10 (c) make on the card. Prints max |K - K64| and max |kff - kff64| for
the reference's float32 associative pass, the port's, and the serial
float32 pass, K64/kff64 being the serial pass in float64 on the same
(float32) inputs, λ = reg_init.
"""
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from mpc_ilqr_tpu.costs.quadratics import CostQuadratics as JQuad  # noqa: E402
from mpc_ilqr_tpu.ops.assoc_riccati import backward_pass_assoc as j_assoc  # noqa: E402
from mpc_ilqr_tpu_torch.costs.quadratics import CostQuadratics  # noqa: E402
from mpc_ilqr_tpu_torch.ops import riccati  # noqa: E402
from mpc_ilqr_tpu_torch.ops.assoc_riccati import backward_pass_assoc  # noqa: E402


def main():
    li = chip_smoke.long_horizon_inputs(device="cpu")
    cfg, args = li["prob"].cfg, li["args"]
    reg, pd = cfg.reg_init, cfg.pd_bump
    a64 = [t.double() for t in args]
    K64, k64 = riccati.backward_pass_plain(*a64, reg, pd)
    jK, jk = jax.jit(lambda A, B, *q: j_assoc(A, B, JQuad(*q), jnp.float32(reg), pd))(
        *[jnp.asarray(t.numpy()) for t in args])
    tK, tk = backward_pass_assoc(args[0], args[1], CostQuadratics(*args[2:]),
                                 torch.tensor(reg), pd)
    sK, sk = riccati.backward_pass_plain(*args, torch.tensor(reg), pd)
    err = lambda a, b: float(np.abs(np.asarray(a, dtype=np.float64) - b.numpy()).max())
    print(f"long-horizon inputs, N={cfg.N}, float32, max|K64| {float(K64.abs().max()):.3e}")
    for label, K, k in (("reference backward_pass_assoc", jK, jk),
                        ("port backward_pass_assoc", tK, tk),
                        ("serial float32 (backward_pass_plain)", sK, sk)):
        print(f"  {label}: |K - K64| {err(K, K64):.3e}, |kff - kff64| {err(k, k64):.3e}")
    print({"K": float(f"{err(jK, K64):.4g}"), "kff": float(f"{err(jk, k64):.4g}")})


if __name__ == "__main__":
    main()
