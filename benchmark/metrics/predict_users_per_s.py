"""predict_users_per_s: users whose top-N lists came back to the host,
over the window's wall time, host clock."""

from benchmark import arith


def read(run):
    if run.kind != "serve":
        return None
    return arith.rate(sum(u.work for u in run.units), run.start, run.end)
