"""Run one cell of the benchmark and print its result as the last line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (from the process's start): the program's problem, the fleet drawn
from the seed on the device, the CUDA kernels from the checkout's
build/torch_kernels/ (built there by the first run), and the warm-up: the
cell's chunk step once at its shapes, thrown away. The window: chunk steps
in turn until `--seconds` have passed; the chunk then in flight ends it.
With `--trace 0` the result holds the cell's end-to-end metrics; with
`--trace 1` the window is the traffic's `traced_chunks` chunk steps under
torch.profiler with spans around the program's layers, and the result holds
the per-layer metrics and a breakdown. Then the program's state is freed
and check.py judges what the window produced against the plain reference.

Exits 2 without a card (or with fewer than the cell asks for), 3 if JAX or
the JAX package was loaded; neither prints a result.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "mpc_ilqr_tpu")


def _process_age() -> float:
    """Seconds since this process started (/proc), or 0 where unreadable."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE_AT_IMPORT = _process_age()
_T_IMPORT = time.perf_counter()


def since_start() -> float:
    return _AGE_AT_IMPORT + time.perf_counter() - _T_IMPORT


def cache_dirs(root: str) -> dict:
    """Fixed build and kernel-cache directories inside the checkout."""
    build = os.path.join(root, "build")
    return dict(TORCH_EXTENSIONS_DIR=os.path.join(build, "torch_extensions"),
                TRITON_CACHE_DIR=os.path.join(build, "triton_cache"),
                CUDA_CACHE_PATH=os.path.join(build, "cuda_cache"))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, device, root: str = ROOT) -> dict:
    """One run of a cell (cells.Cell) on `device`: the result's fields."""
    import torch

    from benchmark import check
    from benchmark import trace as tr
    from benchmark.cells import metric_reader

    cuda = torch.device(device).type == "cuda"
    marks = [since_start()]
    gen = importlib.import_module("benchmark.generators." + cell.traffic["generator"])
    run = gen.FleetRun(cell.config, cell.traffic, int(cell.settings["chunk"]), seed, device, root)
    marks.append(since_start())
    run.warm_up(int(cell.traffic["warm_up_chunks"]))
    marks.append(since_start())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    summary = {}
    if trace:
        with tr.program_spans(), tr.Profile(cuda) as prof:
            setup_s = since_start()
            chunks, window_s = run.window(seconds, max_chunks=int(cell.traffic["traced_chunks"]))
        summary = tr.read(prof.events)
        if summary:
            summary["device_traced"] = cuda
        del prof
    else:
        setup_s = since_start()
        chunks, window_s = run.window(seconds)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    counters = run.counters()
    model = run.prob.model
    shape = dict(N=run.cfg.N, nx=model.nx, nu=model.nu, chunk=run.chunk)
    records, draws, chunk_ends = run.records, run.draws, run.chunk_ends
    run.free()

    ref = check.reference_outputs(records, draws, cell.config, root, device)
    numbers = check.compare(check.program_outputs(records), ref)
    correct, checks = check.verdict(numbers, cell.settings)

    metrics = {}
    if trace:
        ctx = dict(trace=summary, counters=counters, window_peak_bytes=window_peak, shape=shape)
        for m in cell.per_layer:
            value = metric_reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"instance_steps_per_s": counters["instance_steps"] / window_s,
               "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": max(peak, window_peak)}
    result = {"correct": correct, "attempted": counters["instance_steps"],
              "failed": counters["failed"], "metrics": metrics, "device": dev}
    if trace and summary:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = tr.breakdown(summary)
    result["window"] = {"chunks": chunks, "seconds": window_s, "chunk": run.chunk,
                        "chunk_ends_s": chunk_ends}
    # set-up by part: the interpreter to this module's import, the imports of torch
    # and the program, the problem and the fleet (with the card's context), the warm-up
    result["setup_parts_s"] = {"interpreter": _AGE_AT_IMPORT,
                               "imports": marks[0] - _AGE_AT_IMPORT,
                               "problem_and_fleet": marks[1] - marks[0],
                               "warm_up": marks[2] - marks[1]}
    result["checks"] = checks  # last: the numbers compared, each with its limit
    return result


def emit(result: dict) -> None:
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.update(cache_dirs(ROOT))
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark.cells import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count()={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # one host thread: the port's host work is dispatch
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}; the port must not", file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
