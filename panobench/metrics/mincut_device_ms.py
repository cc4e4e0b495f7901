"""Device time of the min-cut kernels (``csrc/mincut.cu``,
``csrc/mincut_tiled.cu`` and their headers), by kernel name from the
profiler's trace, ms per traced stitch request."""

KERNELS = {"resident_round_kernel", "tiled_round_kernel", "init_kernel",
           "side_kernel"}


def read(ctx):
    if ctx.trace is None:
        return None
    n = sum(1 for k, _, _ in ctx.trace.requests if k == "stitch")
    ms = ctx.trace.kernels_matching(KERNELS) * 1e3
    return ms / n if n and ms > 0 else None
