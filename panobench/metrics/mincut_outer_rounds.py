"""Outer rounds (push phases then one BFS each) of the card's min-cut
solves (the program's counter ``mincut.outer``, kernels 1 and 2), per
stitch over every stitch of the process (the program's ``bundle_adjust``
stage count), the set-up's cold one included. None where the program
keeps no such counter, or solved no cut on the card."""

from simplepanorama_tpu_torch.utils.timing import global_timer


def read(ctx):
    timer = global_timer()
    v = getattr(timer, "counters", {}).get("mincut.outer")
    n = timer.counts.get("bundle_adjust")
    return v / n if n and v is not None else None
