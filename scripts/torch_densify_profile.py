"""Where the densify kernel's callers spend their time on one NVIDIA card,
at the ML-20M synth workload (``datagen.synth_ml20m(seed=0)``, l1r = l2r
= 1), through the PyTorch port's public functions only, so that one
script measures any revision of ``slim_tpu_torch``:

    python3 scripts/torch_densify_profile.py [--out DIR] [--ctas 1,2]
    python3 scripts/torch_densify_profile.py --device cpu --scale 0.02

Run from a checkout; the package is imported from the checkout that holds
this script.  Prints one ``name: {json}`` line per measurement and, with
``--out``, writes them all to ``DIR/densify_profile.json``:

* ``gram``: ``ops.gram.compute_gram(mode="device")`` of the whole matrix,
  its wall time (least of 3) and one profiled call's device time split
  into the densify kernel, the products and the rest (elementwise adds,
  fills, copies), with the host's share (wall - device busy);
* ``learn``: the learn's ``phases`` (gram, solve, ...); ``warm_learn``:
  a learn warm-started from that model (its ``warm x0`` phase densifies
  each block's x0);
* ``predict``: ``predict_topn`` of every user with W resident at "high"
  and "highest" (two rounds in turns, each its least) and one profiled
  "high" call split into densify, products, top-k and the rest;
* ``densify``: one densify call, timed by CUDA events (mean of 10), at
  the first block of the Gram (``densify_runs``, the longest rows, int8
  out), the first user block of the "high" predict (the longest
  histories, bfloat16 out) and chip_smoke phase 2's (W, R) layout
  (``densify``, f32 and bfloat16), each with the allocation of its output
  block (zeroed where the revision's densify accumulates, empty where it
  overwrites); and ``predict.densify_model`` of the learned model (least
  of 3).  ``--ctas 1,2`` repeats them at each ``CTAS_PER_SM`` of the
  kernel's tiles.

Every time is on the card named by the ``card:`` line (nvidia-smi's name
and power limit).
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CFG = dict(l1r=1.0, l2r=1.0, optTol=1e-7, maxniters=10000, block_size=1024)
# what a kernel's name says it is, first match wins
CATEGORIES = (("densify", ("densify",)),
              ("product", ("gemm", "Gemm", "GEMM", "cutlass", "xmma",
                           "nvjet", "_mm", "Kernel2")),
              ("topk", ("topk", "TopK", "sort", "Sort", "radix", "Radix",
                        "bitonic", "scan")),
              ("copy/fill", ("copy", "Copy", "fill", "Fill", "Memcpy",
                             "Memset")))


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev, reps=3):
    """(result, least wall seconds of ``reps`` calls ending in a sync)."""
    best, res = float("inf"), None
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        res = fn()
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    return res, best


def category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other"


def profiled(fn, dev):
    """One profiled call: wall seconds, device seconds by category, the
    host's share of the wall (1 - busy / wall) and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    by_cat = {}
    for e in rows:
        c = category(e.key)
        by_cat[c] = by_cat.get(c, 0.0) + e.self_device_time_total / 1e6
    busy = sum(by_cat.values())
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
    return dict(wall_s=wall, device_s=by_cat, device_busy_s=busy,
                host_share=1.0 - busy / wall if wall else 0.0,
                top=[dict(name=e.key[:100], calls=e.count,
                          s=e.self_device_time_total / 1e6) for e in top])


def event_ms(fn, dev, reps=10):
    """Mean milliseconds of ``fn()`` by CUDA events (host clock on the
    CPU), after one warm-up call."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    sync(dev)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    sync(dev)
    return a.elapsed_time(b) / reps


def runs_call(densify_runs, overwrites):
    """A caller's densify_runs call: the output block made as this
    revision's callers make it (empty where densify_runs can overwrite)."""
    def call(idx, val, rs, rl, npad, n_valid, shape, dtype, dev):
        if overwrites:
            out = torch.empty(shape, dtype=dtype, device=dev)
            return densify_runs(idx, val, rs, rl, npad, n_valid, out,
                                accumulate=False)
        out = torch.zeros(shape, dtype=dtype, device=dev)
        return densify_runs(idx, val, rs, rl, npad, n_valid, out)
    return call


def densify_shapes(trn, npad, dev):
    """The caller shapes timed: the Gram's first block (the longest rows:
    their pow2 width, capped at 4,096 entries, times the rows stays within
    2^23, ops/gram._row_block; int8 out), the "high" predict's first user
    block (4,096 users of the longest histories, predict._user_block at
    npad 28,672; bfloat16 out), and chip_smoke phase 2's (W, R) layout
    (W 256, R 8192, integer values 1-5)."""
    from slim_tpu_torch.ops.densify import densify_meta

    row_nnz = np.diff(trn.indptr).astype(np.int64)
    order = np.argsort(-row_nnz, kind="stable")
    idx = trn.dev_put("idx32", lambda: trn.indices.astype(np.int32), dev)
    w = min(max(32, 1 << (int(row_nnz[order[0]]) - 1).bit_length()), 4096)
    R = min(next((rb for rb in (8192, 4096, 2048, 1024, 512, 256)
                  if w * rb <= (1 << 23)), 256), trn.nrows)
    rows, users = order[:R], order[:min(4096, trn.nrows)]
    rng = np.random.default_rng(0)
    W, RL = 256, 8192
    lens = rng.integers(0, W + 1, RL)
    ids = rng.integers(0, npad, (W, RL)).astype(np.int32)
    ids[np.arange(W)[:, None] >= lens[None, :]] = npad
    idsT = torch.from_numpy(ids).to(dev)
    valsT = torch.from_numpy(rng.integers(1, 6, (W, RL)).astype(
        np.float32)).to(dev)
    return dict(
        gram_ml20m=(idx, None, trn.indptr[rows], row_nnz[rows], None,
                    torch.int8),
        hist_ml20m=(idx, None, trn.indptr[users], row_nnz[users],
                    trn.ncols, torch.bfloat16),
        layout=(idsT, valsT, densify_meta(idsT, npad)))


def densify_times(D, model, npad, dev, shapes, overwrites):
    """Milliseconds of one densify call at each shape (CUDA events, mean
    of 10) and of the model densify (least of 3)."""
    from slim_tpu_torch.predict import densify_model

    call = runs_call(D.densify_runs, overwrites)
    rec = {}
    for name in ("gram_ml20m", "hist_ml20m"):
        idx, val, rs, rl, n_valid, dt = shapes[name]
        rec[name] = dict(R=len(rl), entries=int(rl.sum()),
                         longest=int(rl.max()), ms=event_ms(lambda: call(
                             idx, val, rs, rl, npad, n_valid,
                             (npad, len(rl)), dt, dev), dev))
    idsT, valsT, wmax = shapes["layout"]
    for name, dt in (("layout_f32", torch.float32),
                     ("layout_bf16", torch.bfloat16)):
        rec[name] = dict(ms=event_ms(lambda: D.densify(
            idsT, valsT, wmax, npad, out_dtype=dt), dev))
    rec["densify_model_s"] = timed(
        lambda: densify_model(model, npad, dev), dev)[1]
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="datagen.synth_ml20m's scale (1: the full shape)")
    ap.add_argument("--out", help="directory for densify_profile.json")
    ap.add_argument("--ctas", help="comma-separated values of "
                    "ops.densify.CTAS_PER_SM to time the densify at")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from slim_tpu_torch import SlimConfig, learn
    from slim_tpu_torch.datagen import synth_ml20m
    from slim_tpu_torch.ops import densify as D
    from slim_tpu_torch.ops.gram import compute_gram, pin_f32
    from slim_tpu_torch.predict import densify_model, predict_topn
    from slim_tpu_torch.solvers.cd import bucket_npad

    pin_f32()
    rec = {}

    def emit(name, value):
        rec[name] = value
        print(f"{name}:", json.dumps(value), flush=True)

    if dev.type == "cuda":
        emit("card", subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0])
    trn = synth_ml20m(seed=0, scale=args.scale)
    npad = bucket_npad(trn.ncols)
    overwrites = "accumulate" in inspect.signature(D.densify_runs).parameters
    emit("workload", dict(nrows=trn.nrows, ncols=trn.ncols, nnz=trn.nnz,
                          npad=npad, densify_overwrites=overwrites))

    gram = lambda: compute_gram(trn, "device", pad_to=npad, device=dev)
    G, gram_s = timed(gram, dev)
    del G
    emit("gram", dict(least_wall_s=gram_s, profiled=profiled(gram, dev)))

    model, stats = learn(trn, SlimConfig(**CFG), device=dev)
    emit("learn", dict(learn_s=stats["learn_s"], phases=stats["phases"],
                       objective=stats["loss"], nnz=stats["nnz"]))

    _, wstats = learn(trn, SlimConfig(**CFG), imodel=model, device=dev)
    emit("warm_learn", dict(learn_s=wstats["learn_s"],
                            phases=wstats["phases"],
                            objective=wstats["loss"], nnz=wstats["nnz"]))

    W = densify_model(model, npad, dev)

    def pred(p):
        return predict_topn(model, trn, nrcmds=10, W_dev=W, precision=p,
                            device=dev)
    secs = {"high": [], "highest": []}
    for _ in range(2):
        for p in secs:
            secs[p].append(timed(lambda: pred(p), dev, reps=1)[1])
    emit("predict", dict(
        users=trn.nrows,
        least_s={p: min(s) for p, s in secs.items()}, runs_s=secs,
        high_profiled=profiled(lambda: pred("high"), dev)))
    del W

    shapes = densify_shapes(trn, npad, dev)
    if args.ctas:
        for k in args.ctas.split(","):
            D.CTAS_PER_SM = int(k)
            emit(f"densify ctas_per_sm={k}", densify_times(
                D, model, npad, dev, shapes, overwrites))
    else:
        emit("densify", densify_times(D, model, npad, dev, shapes,
                                      overwrites))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "densify_profile.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
