"""Roofline bounds of the port's kernels on an H100 SXM (80 GB HBM3): the
bytes a kernel's work must move, from the shapes a learn reports, and the
time the card's memory bandwidth allows for them."""

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3


def gather_bytes(widths: dict, npad: int, block: int) -> int:
    """Bytes one learn's compact gathers must move: for each block solved
    in a union of width K < npad (``widths``: K -> blocks, the solver's
    ``stats["union_widths"]``), G[S, S] (K x K) and the targets' rows
    G[j, S] (``block`` x K), each float32 entry read once and written
    once: 8 K^2 + 8 block K."""
    return sum(n * (8 * k * k + 8 * block * k)
               for k, n in widths.items() if int(k) < npad)


def bytes_seconds(nbytes: float) -> float:
    """Seconds the card's memory bandwidth needs for ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S
