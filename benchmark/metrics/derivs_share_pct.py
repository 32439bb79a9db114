"""Share of the traced window the host spent in the derivatives:
`ilqr.solver.linearize` (engine.step_and_jac under vmap over knots and
instances) and `costs.quadratics.quadraticize_gn`, by the benchmark's spans."""


def read(ctx):
    tr = ctx.get("trace") or {}
    spans = tr.get("span_s", {})
    if "linearize" not in spans or not tr.get("window_s"):
        return None
    return 100.0 * (spans["linearize"] + spans.get("quadraticize", 0.0)) / tr["window_s"]
