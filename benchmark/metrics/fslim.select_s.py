"""fslim.select_s: the solver's ``phases["select"]`` (PhaseTimer, host clock
after a sync of the current stream: FSLIM's neighbour top-k and the unions
of the compact path), mean per learn of the traced window.  None where no
learn has the phase (SLIM, FSLIM at full width, or a program without it)."""

from statistics import fmean


def read(run):
    got = [u.stats["phases"]["select"] for u in run.units
           if u.stats is not None and "select" in u.stats["phases"]]
    return fmean(got) if got else None
