"""The device memory the window allocated at its peak
(`torch.cuda.max_memory_allocated()` after a reset at the window's start)."""


def read(ctx):
    peak = ctx.get("window_peak_bytes")
    return None if not peak else peak / 2 ** 30
