"""The traced window: ``torch.profiler`` (host and device activity) around
the window, its Chrome trace read back into plain interval lists.

The window and each unit are spans of the benchmark's own
(``record_function``), so the trace's clock gives the window's length.
Device activity is every kernel, copy and fill; host activity every
operator, runtime call and span.  The trace goes to a file in the
temporary directory and is deleted once read.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

from . import arith

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
TOP = 10
NAME_CHARS = 160   # a breakdown's names are cut to this length


@dataclasses.dataclass
class Trace:
    """Intervals in microseconds of the trace's clock."""
    device_names: list
    device: np.ndarray        # (k, 2) start, end
    host_names: list
    host: np.ndarray
    lo: float                 # the window span
    hi: float

    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    def busy_s(self) -> float:
        """Seconds of the window in which some device activity ran."""
        return arith.union_length(self.device, self.lo, self.hi) * 1e-6

    def device_s(self, names) -> float:
        """Device seconds, inside the window, of the activities whose name
        holds one of ``names``."""
        sel = [i for i, n in enumerate(self.device_names)
               if any(k in n for k in names)]
        d = np.clip(self.device[sel], self.lo, self.hi)
        return float((d[:, 1] - d[:, 0]).sum()) * 1e-6

    def device_ops(self, top: int = TOP) -> list:
        """The ``top`` device activities by summed time in the window."""
        d = np.clip(self.device, self.lo, self.hi)
        tot = collections.Counter()
        for name, dur in zip(self.device_names, d[:, 1] - d[:, 0]):
            if dur > 0:
                tot[name] += float(dur)
        return [[n[:NAME_CHARS], s * 1e-6] for n, s in tot.most_common(top)]

    def idle_gaps(self, top: int = TOP) -> list:
        """Idle device time in the window, summed by what the host was
        doing (the innermost host span over each gap's middle; "none"
        where no span covers it), the ``top`` largest."""
        g = arith.gaps(self.device, self.lo, self.hi)
        if len(g) == 0:
            return []
        mid = g.mean(axis=1)
        label = np.full(len(g), -1)
        h = self.host
        a = np.searchsorted(mid, h[:, 0], side="left")
        b = np.searchsorted(mid, h[:, 1], side="right")
        cand = np.flatnonzero(b > a)
        for i in cand[np.argsort(-(h[cand, 1] - h[cand, 0]), kind="stable")]:
            label[a[i]:b[i]] = i          # longer spans first, inner last
        tot = collections.Counter()
        for lab, dur in zip(label, g[:, 1] - g[:, 0]):
            tot["none" if lab < 0 else self.host_names[lab]] += float(dur)
        return [[n, s * 1e-6] for n, s in tot.most_common(top)]

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops(), "idle_gaps": self.idle_gaps()}


def parse(events) -> Trace:
    """A :class:`Trace` from Chrome trace events (``traceEvents``)."""
    dev_n, dev_t, host_n, host_t, win = [], [], [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, t0 = e.get("cat", ""), float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev_n.append(e["name"])
            dev_t.append((t0, t1))
        elif cat in HOST_CATS:
            if e["name"] == WINDOW:
                win = (t0, t1)
            else:
                host_n.append(e["name"])
                host_t.append((t0, t1))
    if win is None:
        raise ValueError(f"the trace holds no {WINDOW!r} span")
    return Trace(dev_n, np.asarray(dev_t, np.float64).reshape(-1, 2),
                 host_n, np.asarray(host_t, np.float64).reshape(-1, 2),
                 *win)


class Capture:
    """``with Capture(dev) as cap:`` profiles the block; ``cap.span(name)``
    is a named span inside it; ``cap.trace`` is set on exit."""

    def __init__(self, dev):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.trace = None

    @staticmethod
    def span(name: str):
        from torch.profiler import record_function

        return record_function(name)

    def __enter__(self):
        self.prof.__enter__()
        self._win = self.span(WINDOW)
        self._win.__enter__()
        return self

    def __exit__(self, *exc):
        self._win.__exit__(*exc)
        t0 = time.perf_counter()
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        t1 = time.perf_counter()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            t2 = time.perf_counter()
            size = os.path.getsize(path)
            with open(path) as f:
                self.trace = parse(json.load(f)["traceEvents"])
        finally:
            with contextlib.suppress(FileNotFoundError):
                os.remove(path)
        print(f"trace: profiler stop {t1 - t0:.3f} s, export {t2 - t1:.3f} s "
              f"({size} bytes), read {time.perf_counter() - t2:.3f} s "
              f"({len(self.trace.device_names)} device, "
              f"{len(self.trace.host_names)} host events)",
              file=sys.stderr, flush=True)
        return False
