"""screen.work_pct: the share of full-width sweep work that the l1 screen's
unions leave, 100 x (sum over blocks of K^2 x sweeps) / (sum over blocks of
npad^2 x sweeps), from the solver's ``stats["sweep_work"]`` (those two
sums), mean per learn of the traced window.  None where no learn reports
the sums (a program without the counter)."""

from statistics import fmean


def read(run):
    got = [100.0 * w[0] / w[1] for w in
           ((u.stats or {}).get("sweep_work") for u in run.units)
           if w and w[1] > 0]
    return fmean(got) if got else None
