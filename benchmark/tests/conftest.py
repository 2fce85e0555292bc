"""Fixtures of the benchmark's own tests (``python -m pytest
benchmark/tests``): the checkout on the import path, and a scratch copy of
the manifest and the data files in which a test adds a configuration, a
mix, a kind of traffic, a metric or a cell without touching the
checkout."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


class Scratch:
    """A copy of ``BENCHMARK.json`` and the benchmark's data files, kinds
    and readers under ``root``."""

    def __init__(self, root: Path):
        self.root = root
        self.bases = {}
        shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
        for sub in ("configs", "traffic", "kinds", "limits", "metrics"):
            shutil.copytree(ROOT / "benchmark" / sub, root / "benchmark" / sub)

    @property
    def manifest(self) -> dict:
        return json.loads((self.root / "BENCHMARK.json").read_text())

    def save(self, manifest: dict) -> None:
        (self.root / "BENCHMARK.json").write_text(json.dumps(manifest))

    def add_config(self, name: str, base: str = "ml1m", **changes) -> None:
        """A configuration ``name``: ``base``'s file with ``changes``."""
        cfg = json.loads((ROOT / "benchmark" / "configs"
                          / f"{base}.json").read_text())
        slim = changes.pop("slim", {})
        cfg.update(changes, name=name)
        cfg["slim"].update(slim)
        self.bases[name] = base
        path = f"benchmark/configs/{name}.json"
        (self.root / path).write_text(json.dumps(cfg))
        m = self.manifest
        m["configs"].append({"name": name, "source": "test", "file": path,
                             "reduced": [], "why": "a test's small shape"})
        self.save(m)

    def add_cell(self, name: str, config: str, traffic: str,
                 like: str | None = None, limits: str | None = None) -> None:
        """A one-chip cell that reports every metric the cell ``like``
        reports (by default ``ml20m.<kind>``), with the limits of the cell
        ``limits`` (by default ``<base configuration>.<kind>``)."""
        m = self.manifest
        m["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "a test's cell"})
        kind = json.loads((self.root / "benchmark" / "traffic"
                           / f"{traffic}.json").read_text())["kind"]
        like = like or f"ml20m.{kind}"
        limits = limits or f"{self.bases.get(config, config)}.{kind}"
        lim = self.root / "benchmark" / "limits"
        shutil.copy(lim / f"{limits}.json", lim / f"{name}.json")
        for metric in m["end_to_end"] + m["per_layer"]:
            if like in metric.get("workloads", ()):
                metric["workloads"].append(name)
        self.save(m)


@pytest.fixture
def scratch(tmp_path) -> Scratch:
    return Scratch(tmp_path)


@pytest.fixture
def small(scratch) -> Scratch:
    """The scratch copy with a small configuration and its three cells:
    ``small.learn``, ``small.serve`` (resident) and ``small.unpinned``."""
    scratch.add_config("small", users=300, items=120, ratings=6000,
                       serve_model_nnz=3000, slim={"block_size": 64})
    scratch.add_cell("small.learn", "small", "learn_loop")
    scratch.add_cell("small.serve", "small", "serve_resident")
    scratch.add_cell("small.unpinned", "small", "serve_unpinned")
    return scratch


@pytest.fixture
def card():
    """The first CUDA card; skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
