"""compact.gather_s: the solver's ``phases["compact-gather"]`` (PhaseTimer,
host clock after a sync of the current stream; the span
``slim.cd.compact-gather``):
each compact block's G[S, S], G[j, S] and diagonal gathers, summed over
the learn's blocks, mean per learn of the traced window.  None where no
learn has the phase (full-width learns, or a program without it)."""

from statistics import fmean


def read(run):
    got = [u.stats["phases"]["compact-gather"] for u in run.units
           if u.stats is not None and "compact-gather" in u.stats["phases"]]
    return fmean(got) if got else None
