"""learn_cols_per_s: item columns learned over all the window's time, host
clock (each learn ends with its model on the host)."""

from benchmark import arith


def read(run):
    if run.kind != "learn":
        return None
    return arith.rate(sum(u.work for u in run.units), run.start, run.end)
