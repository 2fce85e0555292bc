"""device_idle_pct.learn: 100 x (1 - the union of device kernel, copy and fill
intervals / the traced window's wall), from the torch.profiler trace."""

from benchmark import arith


def read(run):
    if run.trace is None or run.kind != "learn":
        return None
    t = run.trace
    return arith.idle_pct(t.device, t.lo, t.hi)
