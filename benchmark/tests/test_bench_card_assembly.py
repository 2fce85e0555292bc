"""``learn.card_assembly_pct`` on hand-made runs: the share of the
window's learns whose model was assembled on the card, from the solver's
``stats["assembly"]``; None where no learn reports it."""

import pytest

from benchmark import harness
from benchmark.loops import Unit
from test_bench_program_spans import reader


def _run(*routes):
    units = [Unit(0, 0.0005, 1000, stats={"sweeps": 20, "phases": {}}
                  if r is None else {"sweeps": 20, "phases": {},
                                     "assembly": r})
             for r in routes]
    return harness.Run("c", "learn", 1.0, 0.0, 0.001, units, 0)


@pytest.mark.parametrize("routes,want", [
    (("card",) * 3, 100.0),
    (("card", "host", "card", "card"), 75.0),
    (("host", "host"), 0.0)])
def test_card_assembly_is_the_share_of_card_learns(routes, want):
    assert reader("learn.card_assembly_pct")(_run(*routes)) == \
        pytest.approx(want)


def test_card_assembly_reads_none_where_no_learn_reports_it():
    read = reader("learn.card_assembly_pct")
    assert read(_run(None, None)) is None
    assert read(_run()) is None
