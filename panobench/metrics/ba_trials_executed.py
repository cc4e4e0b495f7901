"""The BA's LM trials executed (the program's counter
``ba.trials_executed``: the runs' own trials, the no-op ones replayed
after a run ended before the next read of its termination flag, and a
capture's warm-up trial), per stitch over every stitch of the process
(the program's ``bundle_adjust`` stage count): the window's and the
set-up's cold one. A trial count does not depend on the profiler, and
the harness hands a reader no window delta of the program's counters.
None where the program keeps no counters."""

from simplepanorama_tpu_torch.utils.timing import global_timer


def read(ctx):
    timer = global_timer()
    v = getattr(timer, "counters", {}).get("ba.trials_executed")
    n = timer.counts.get("bundle_adjust")
    return v / n if n and v is not None else None
