"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, the run length's budget, the files each entry names, and which
cell reports which metric."""

import json
import re

from benchmark import harness
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}

M = json.loads((ROOT / "BENCHMARK.json").read_text())


def one_line(s, most=200):
    return isinstance(s, str) and 1 <= len(s) <= most and "\n" not in s \
        and "\t" not in s


def reported(metric, cell):
    e2e = {m["name"]: m for m in M["end_to_end"]}
    if "workloads" in metric:
        return cell in metric["workloads"]
    if metric in M["end_to_end"]:
        return True
    return reported(e2e[metric["moves"]], cell)


def test_keys_and_command():
    assert set(M) == KEYS
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert 1 <= len(M["command"]) <= 32
    assert all(one_line(w) for w in M["command"])
    files = [w for w in M["command"] if "/" in w]
    assert files and all(any(f.startswith(p + "/") for p in M["paths"])
                         for f in files)
    assert (ROOT / files[0]).is_file()


def test_names_units_and_entry_keys():
    names = []
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        names.append(w["name"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in SOURCES_E2E
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and one_line(m["layer"])
    assert len(names) == len(set(names))
    assert len(json.dumps(M)) <= 64 * 1024


def test_counts_bounds_and_chips():
    assert 1 <= len(M["configs"]) <= 24 and 1 <= len(M["workloads"]) <= 24
    assert 1 <= len(M["end_to_end"]) <= 16 and 1 <= len(M["per_layer"]) <= 128
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in M["end_to_end"]}["setup_s"] <= 0.25
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
    pairs = {(w["config"], w["traffic"]) for w in M["workloads"]}
    assert len(pairs) == len(M["workloads"])
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = M["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_named_by_the_manifest_exist():
    bench = ROOT / M["paths"][0]
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert c["file"].startswith(M["paths"][0] + "/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    for w in M["workloads"]:
        mix = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (bench / "kinds" / f"{mix['kind']}.py").is_file()
        lim = json.loads((bench / "limits" / f"{w['name']}.json")
                         .read_text())
        assert set(lim) == {"control", "limits"} and lim["limits"]
        kind = harness.Bench(ROOT).kind(mix["kind"])
        assert lim["control"] in kind.CONTROLS
    for m in M["end_to_end"] + M["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").is_file()


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    for w in M["workloads"]:
        cell = w["name"]
        e2e = [m["name"] for m in M["end_to_end"] if reported(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(reported(m, cell) for m in M["per_layer"]), cell


def test_each_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in M["workloads"]]):
            assert reported(e2e[m["moves"]], cell), (m["name"], cell)
