"""learn.gram_s: the solver's ``phases["gram"]`` (PhaseTimer, host clock
after a sync of the current stream), mean per learn of the traced window."""

from statistics import fmean


def read(run):
    got = [u.stats["phases"].get("gram", 0.0) for u in run.units
           if u.stats is not None]
    return fmean(got) if got else None
