"""Choose a cell's chunk: one sweep on the card over chunk sizes.

    python3 -m benchmark.sweep --config h1_n25 [--chunks 128 256 512 1024] [--seed 1]

For each size (in one process, smallest first): the fleet of traffic
`fleet` at that chunk, one chunk step to warm its shapes, then one timed
chunk step; prints a JSON line per size with seconds per chunk step, instance
steps per second and the peak of allocated memory against the card's. A
size that runs out of memory ends the sweep. A cell takes the largest chunk
whose peak leaves a fifth of the card free (cells/<workload>.json).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", default="fleet")
    ap.add_argument("--chunks", type=int, nargs="+", default=[128, 256, 512, 1024])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    from benchmark.run import cache_dirs
    os.environ.update(cache_dirs(ROOT))
    import torch

    from benchmark.generators.fleet_closed_loop import FleetRun

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "benchmark", "configs", args.config + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "traffic", args.traffic + ".json")) as f:
        traffic = json.load(f)
    total = torch.cuda.get_device_properties(0).total_memory
    for chunk in sorted(args.chunks):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        line = dict(config=args.config, chunk=chunk, card_bytes=total,
                    card=torch.cuda.get_device_name(0))
        try:
            run = FleetRun(config, traffic, chunk, args.seed, "cuda", ROOT)
            t0 = time.perf_counter()
            run.warm_up(1)
            line["warm_up_s"] = time.perf_counter() - t0
            steps, seconds = run.window(0.0, max_chunks=1)
            line.update(chunk_s=seconds, instance_steps_per_s=chunk * steps / seconds,
                        peak_bytes=torch.cuda.max_memory_allocated(),
                        peak_share=torch.cuda.max_memory_allocated() / total)
            run.free()
            del run
        except torch.cuda.OutOfMemoryError as e:
            line["out_of_memory"] = str(e).splitlines()[0]
            print(json.dumps(line), flush=True)
            break
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
