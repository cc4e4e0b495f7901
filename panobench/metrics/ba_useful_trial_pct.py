"""Share of the BA's executed LM trials that belonged to a run (the
program's counters ``ba.lm_trials`` over ``ba.trials_executed``), %, over
every stitch of the process: the rest are no-op trials after a run's end
and capture warm-ups. None where the program keeps no counters."""

from simplepanorama_tpu_torch.utils.timing import global_timer


def read(ctx):
    counters = getattr(global_timer(), "counters", {})
    useful = counters.get("ba.lm_trials")
    executed = counters.get("ba.trials_executed")
    if useful is None or not executed:
        return None
    return 100.0 * useful / executed
