"""learn.sweep_kernel_ms: device time of the CD sweep kernels in the traced
window (names listed in learn.sweep_kernel_ms.kernels.txt, matched as
substrings of the trace's kernel names) per block sweep."""

from pathlib import Path

NAMES = [n.strip() for n in Path(__file__).with_name(
    "learn.sweep_kernel_ms.kernels.txt").read_text().splitlines()
    if n.strip() and not n.startswith("#")]


def read(run):
    sweeps = sum(u.stats["sweeps"] for u in run.units if u.stats is not None)
    if run.trace is None or sweeps == 0:
        return None
    s = run.trace.device_s(NAMES)
    return 1e3 * s / sweeps if s > 0 else None
