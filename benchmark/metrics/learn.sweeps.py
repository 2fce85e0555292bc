"""learn.sweeps: the solver's count of block sweeps (stats["sweeps"]),
mean per learn of the traced window (the same count in every learn of a
seed)."""

from statistics import fmean


def read(run):
    got = [u.stats["sweeps"] for u in run.units if u.stats is not None]
    return fmean(got) if got else None
