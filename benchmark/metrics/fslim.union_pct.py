"""fslim.union_pct: the share of full width that a learn's block solves
carry, 100 x the sum over blocks of their coordinate width K / (blocks x
npad), from the solver's ``stats["union_widths"]`` (width -> blocks),
npad being the padded width a block of the learn's catalogue solves at
full width (the solver's own ``bucket_npad``), mean per learn of the
traced window.  None where no learn reports the widths (full-width
learns)."""

from statistics import fmean


def read(run):
    from slim_tpu_torch.solvers.cd import bucket_npad

    got = []
    for u in run.units:
        widths = (u.stats or {}).get("union_widths")
        if widths:
            npad = bucket_npad(u.work)
            blocks = sum(widths.values())
            got.append(100.0 * sum(k * b for k, b in widths.items())
                       / (blocks * npad))
    return fmean(got) if got else None
