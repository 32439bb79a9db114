"""The readings that a cell's limits of `correct` are set from.

    python3 -m benchmark.readings --workload h1_n25.fleet --seeds 11 12 ... \
        [--chunk-steps 3] [--control]

In one process (the set-up is long), for each seed: the cell's fleet and
window as a run makes them (`--chunk-steps` chunk steps, at the cell's
chunk), then check.py's numbers of the program against the float64
reference (the lower readings) and, with `--control`, of the control
against the same reference: the reference computed in float32 with the
inputs of its matrix products rounded to TF32 (the step below the
configuration's float32 with TF32 off), put in the program's place (the
upper readings). One JSON line per seed.
The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tf32(x):
    """x rounded to TF32's 11 significant bits, to nearest (Veltkamp's split
    by 2**13 + 1 in float32 arithmetic): what a TF32 tensor core reads.
    Infinities, NaN and values too large to split pass unchanged."""
    import torch

    c = x * 8193.0
    r = c - (c - x)
    return torch.where(torch.isfinite(r), r, x)


def control_outputs(records, draws, config, root, device):
    """The reference in float32 with TF32 products, in the program's place.

    The inputs of every matrix product are rounded to TF32, as TF32 tensor
    cores round them (float32 accumulation): cuBLAS's own TF32 mode
    (`allow_tf32`) changes nothing at these shapes, whose products run as
    float32 GEMV and small SIMT GEMM kernels (the first chip runs read the
    same gaps with it on as with it off)."""
    import torch
    from torch.overrides import TorchFunctionMode

    from benchmark import check

    products = {torch.matmul, torch.mm, torch.bmm, torch.mv, torch.einsum,
                torch.Tensor.matmul, torch.Tensor.mm, torch.Tensor.bmm, torch.Tensor.mv,
                torch.Tensor.__matmul__, torch.Tensor.__rmatmul__}

    class TF32Products(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in products:
                args = tuple(tf32(a) if isinstance(a, torch.Tensor) and a.is_floating_point()
                             else a for a in args)
            return func(*args, **(kwargs or {}))

    with TF32Products():
        return check.reference_outputs(records, draws, config, root, device, torch.float32)


def row_summary(prog, ref) -> dict:
    """Where the program's gaps lie: per gap the judged rows' median and
    sorted values, and for the worst row of the plan (`prev_ubar`) the knots
    whose own gap is over a tenth of that row's."""
    from benchmark import check

    out = {}
    for k, g in check.row_gaps(prog, ref).items():
        g = g.cpu()
        out[k] = dict(median=float(g.median()), sorted=[float(f"{v:.4g}") for v in g.sort().values])
    pu = prog.state["prev_ubar"].double().cpu()
    ru = ref.state["prev_ubar"].double().cpu()
    rows = check.row_gaps(prog, ref)["prev_ubar"].cpu()
    w = int(rows.argmax())
    knot = (pu[w] - ru[w]).abs().amax(1) / ru[w].abs().max()
    out["prev_ubar_worst_row_knots"] = (knot > 0.1 * knot.max()).nonzero().flatten().tolist()
    return out


def readings(cell, seeds, chunk_steps: int, control: bool, device, root: str = ROOT):
    """Yields one dict per seed: the program's numbers and the control's."""
    import torch

    from benchmark import check
    from benchmark.generators.fleet_closed_loop import FleetRun

    warm = False
    for seed in seeds:
        t0 = time.perf_counter()
        run = FleetRun(cell.config, cell.traffic, int(cell.settings["chunk"]), seed, device, root)
        if not warm:
            run.warm_up(int(cell.traffic["warm_up_chunks"]))
            warm = True
        steps, window_s = run.window(0.0, max_chunks=chunk_steps)
        counters = run.counters()
        records, draws = run.records, run.draws
        run.free()
        del run
        t1 = time.perf_counter()
        ref = check.reference_outputs(records, draws, cell.config, root, device)
        t2 = time.perf_counter()
        prog = check.program_outputs(records)
        line = dict(seed=seed, chunk_steps=steps, window_s=window_s, reference_s=t2 - t1,
                    failed=counters["failed"], instance_steps=counters["instance_steps"],
                    visits=sorted({r.visit for r in records}),
                    program=check.compare(prog, ref), rows=row_summary(prog, ref))
        if control:
            try:
                line["control"] = check.compare(
                    control_outputs(records, draws, cell.config, root, device), ref)
            except (RuntimeError, torch.linalg.LinAlgError) as e:  # a control that crashes has failed
                line["control"] = {"error": str(e).splitlines()[0]}
            line["control_s"] = time.perf_counter() - t2
        yield line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--chunk-steps", type=int, default=0,
                    help="chunk steps per seed (default: the fleet's chunks + 1, so that "
                         "the first chunk steps twice: a cold and a warm start)")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    from benchmark.run import cache_dirs
    os.environ.update(cache_dirs(ROOT))
    import torch

    from benchmark.cells import load_cell

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    steps = args.chunk_steps or int(cell.traffic["instances"]) // int(cell.settings["chunk"]) + 1
    for line in readings(cell, args.seeds, steps, args.control, "cuda"):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
