"""compact.gather_roofline_pct: the compact gathers' share of their
roofline, 100 x the time the card's bandwidth needs for the bytes they
must move (``benchmark/roofline.gather_bytes``: 8 K^2 + 8 B K a compact
block, from each learn's ``stats["union_widths"]`` and
``stats["block_width"]``) / the device time of the gather kernels (names
listed in compact.gather_roofline_pct.kernels.txt, matched as substrings
of the trace's kernel names), over the traced window's learns.  None where
the trace holds no such kernel or no learn reports its unions."""

from pathlib import Path

from benchmark import roofline

NAMES = [n.strip() for n in Path(__file__).with_name(
    "compact.gather_roofline_pct.kernels.txt").read_text().splitlines()
    if n.strip() and not n.startswith("#")]


def read(run):
    from slim_tpu_torch.solvers.cd import bucket_npad

    if run.trace is None or run.kind != "learn":
        return None
    nbytes = sum(roofline.gather_bytes(
        u.stats["union_widths"], bucket_npad(u.work), u.stats["block_width"])
        for u in run.units if u.stats is not None
        and u.stats.get("union_widths") and "block_width" in u.stats)
    s = run.trace.device_s(NAMES)
    return 100.0 * roofline.bytes_seconds(nbytes) / s \
        if nbytes and s > 0 else None
