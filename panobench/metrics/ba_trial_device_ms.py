"""Device time of the LM trial's kernels 4 and 5 (``csrc/ba_trial.cu``:
the per-match streams, and the solve and accept test, with the global
routes of buckets whose data outgrow a CTA's shared memory), by kernel
name from the profiler's trace, ms per traced stitch request. None where
the trace holds none of them."""

KERNELS = {"trial_streams_kernel", "solve_accept_kernel", "pair_tables_kernel",
           "solve_accept_global_kernel"}


def read(ctx):
    if ctx.trace is None:
        return None
    n = sum(1 for k, _, _ in ctx.trace.requests if k == "stitch")
    ms = ctx.trace.kernels_matching(KERNELS) * 1e3
    return ms / n if n and ms > 0 else None
