"""How often a tile of kernel 1's resident route found a neighbour not
yet there: the program's counters ``mincut.push_waits`` over
``mincut.push_checks`` (a tile checks each neighbour's phase word once
per phase and hand-off, before it reads that neighbour's flows or
heights), in percent, over every solve of the process. None where the
program keeps no such counter or made no check."""

from simplepanorama_tpu_torch.utils.timing import global_timer


def read(ctx):
    counters = getattr(global_timer(), "counters", {})
    waits = counters.get("mincut.push_waits")
    checks = counters.get("mincut.push_checks")
    return 100.0 * waits / checks if waits is not None and checks else None
