"""The benchmark's plain reference: a frozen copy of the plain PyTorch path
of `mpc_ilqr_tpu_torch` that one fleet step runs (the dynamics step and its
Jacobians, the Gauss-Newton cost quadratics, the Riccati recursion as a
Python loop of torch.linalg, the masked rollouts of the line search, the
device-side solve and `step_once_device`), with the MJCF loader and the
reference tracks it needs. Each module names the file and lines it was
copied from. It imports nothing of the program and no kernel: the program
may change, this copy does not, and `benchmark/check.py` holds what the
timed path produced against it.
"""
