"""Share of the traced window in which no operation ran on the device
(torch.profiler's CUDA activity: kernels, copies and sets); nothing where
the run traced no device."""


def read(ctx):
    tr = ctx.get("trace") or {}
    if not tr.get("window_s") or not tr.get("device_traced"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
