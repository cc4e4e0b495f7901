"""Share of the BA's executed LM trials that ran through the trial's own
kernels (the program's counters ``ba.fused_trials`` over
``ba.trials_executed``: kernels 4 and 5 around kernel 3, a single-card
program's trial), %, over every stitch of the process. None where the
program keeps no such counter."""

from simplepanorama_tpu_torch.utils.timing import global_timer


def read(ctx):
    counters = getattr(global_timer(), "counters", {})
    fused = counters.get("ba.fused_trials")
    executed = counters.get("ba.trials_executed")
    if fused is None or not executed:
        return None
    return 100.0 * fused / executed
