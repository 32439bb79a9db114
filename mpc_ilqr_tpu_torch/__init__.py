"""mpc_ilqr_tpu_torch — the iLQR-MPC of mpc_ilqr_tpu in PyTorch, with its
rollout kernels in hand-written CUDA for Hopper (sm_90a).

Layout mirrors the JAX package: models, io, dynamics, costs, ilqr, mpc; the
rollout kernels live in ops/ (Python wrappers, packing, build) and csrc/
(CUDA sources). Entry points place tensors on "cuda" unless the caller asks
for device="cpu", where every kernel wrapper runs its plain PyTorch version.

State convention matches MuJoCo: x = [qpos(nq); qvel(nv)], base quaternion
stored wxyz, free-joint velocity = [v_world(3), omega_body(3)].
"""
import torch

# Full float32 everywhere: reduced-precision products NaN the 51-dim Riccati
# chain (the JAX package pins Precision.HIGHEST for the same reason).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
