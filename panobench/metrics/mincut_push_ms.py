"""Device time of the min-cut kernels' push phases, from the card's
clock at grid barriers (the program's counter ``mincut.push_ns``,
kernels 1 and 2), ms per stitch over every stitch of the process (the
program's ``bundle_adjust`` stage count), the set-up's cold one
included: the kernels' own clock, which the profiler does not slow.
None where the program keeps no such counter."""

from simplepanorama_tpu_torch.utils.timing import global_timer


def read(ctx):
    timer = global_timer()
    v = getattr(timer, "counters", {}).get("mincut.push_ns")
    n = timer.counts.get("bundle_adjust")
    return v * 1e-6 / n if n and v is not None else None
