"""Device time of kernel 3, the BA's normal-equation assembly
(``csrc/ba_assemble.cu``), by kernel name from the profiler's trace, ms
per traced stitch request."""

KERNELS = {"assemble_kernel"}


def read(ctx):
    if ctx.trace is None:
        return None
    n = sum(1 for k, _, _ in ctx.trace.requests if k == "stitch")
    ms = ctx.trace.kernels_matching(KERNELS) * 1e3
    return ms / n if n and ms > 0 else None
