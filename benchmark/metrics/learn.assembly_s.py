"""learn.assembly_s: the main thread's share of harvest and assembly, the
solver's phases "assembly", "harvest", "solve-sync" and "pack-fetch"
summed, mean per learn of the traced window."""

from statistics import fmean

PHASES = ("assembly", "harvest", "solve-sync", "pack-fetch")


def read(run):
    got = [sum(u.stats["phases"].get(p, 0.0) for p in PHASES)
           for u in run.units if u.stats is not None]
    return fmean(got) if got else None
