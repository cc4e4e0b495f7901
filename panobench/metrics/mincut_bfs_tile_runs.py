"""Tile runs of kernel 1's resident global-relabel BFSs (the program's
counter ``mincut.bfs_tile_runs``: each resident tile's BFS runs once on
its sinks, then again whenever a neighbour's edge distance drops), per
stitch over every stitch of the process (the program's ``bundle_adjust``
stage count), the set-up's cold one included. None where the program
keeps no such counter."""

from simplepanorama_tpu_torch.utils.timing import global_timer


def read(ctx):
    timer = global_timer()
    v = getattr(timer, "counters", {}).get("mincut.bfs_tile_runs")
    n = timer.counts.get("bundle_adjust")
    return v / n if n and v is not None else None
