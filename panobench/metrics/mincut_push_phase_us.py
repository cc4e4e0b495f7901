"""Device time of one push phase of kernel 1's resident route: the
program's counters ``mincut.push_ns`` (the card's clock over the push
blocks) over ``mincut.push_phases`` (the phases the resident launches
ran), in microseconds, over every solve of the process. None where the
program keeps no such counter or ran no phase."""

from simplepanorama_tpu_torch.utils.timing import global_timer


def read(ctx):
    counters = getattr(global_timer(), "counters", {})
    ns = counters.get("mincut.push_ns")
    phases = counters.get("mincut.push_phases")
    return ns / phases / 1e3 if ns is not None and phases else None
