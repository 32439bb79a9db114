"""K4's share of its roofline: the least time a launch over the chunk could
take (yardstick.riccati_bound_s at the cell's N, nx, nu and chunk) over the
mean device time of the `riccati_backward` launches in the trace."""
from benchmark import yardstick


def read(ctx):
    tr = ctx.get("trace") or {}
    launches = [v for n, v in tr.get("kernels", {}).items() if "riccati_backward" in n]
    count = sum(c for c, _ in launches)
    if not count:
        return None
    mean_s = sum(s for _, s in launches) / count
    sh = ctx["shape"]
    return 100.0 * yardstick.riccati_bound_s(sh["N"], sh["nx"], sh["nu"], sh["chunk"]) / mean_s
