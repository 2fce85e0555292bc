"""learn.card_assembly_pct: the share of the traced window's learns whose
model the port assembled on the card, 100 x learns with
``stats["assembly"] == "card"`` / learns.  None where no learn reports
``stats["assembly"]`` (a program that assembles every model on the host
and says nothing of it)."""


def read(run):
    got = [u.stats["assembly"] for u in run.units
           if u.stats is not None and "assembly" in u.stats]
    return 100.0 * got.count("card") / len(got) if got else None
