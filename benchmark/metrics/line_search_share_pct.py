"""Share of the traced window the host spent in `ilqr.solver.line_search_device`
(the alphas' masked rollouts through ops.linalg.spd_solve and their costs),
by the benchmark's span."""


def read(ctx):
    tr = ctx.get("trace") or {}
    spans = tr.get("span_s", {})
    if "line_search" not in spans or not tr.get("window_s"):
        return None
    return 100.0 * spans["line_search"] / tr["window_s"]
