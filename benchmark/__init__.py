"""The benchmark of `mpc_ilqr_tpu_torch` on an NVIDIA H100.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

BENCHMARK.json (at the checkout's root) names the cells. Everything that
belongs to one configuration, traffic mix, cell or per-layer metric is a
file of its own, found by its name: configs/<config>.json,
traffic/<traffic>.json (read by generators/<generator>.py),
cells/<workload>.json (the chunk and the limits of `correct`) and
metrics/<metric>.py. reference/ is the frozen plain copy that `correct`
is decided against (check.py).
"""
