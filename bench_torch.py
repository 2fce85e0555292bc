"""Benchmark of the PyTorch/CUDA port: SLIM CD learn throughput (item
columns solved per second) at ML-20M scale (synthetic, 138,493 users x
27,278 items x ~20M ratings: ``datagen.synth_ml20m(seed=0)``) on one
NVIDIA card, against the native multithreaded CPU baseline
(``slim_tpu_torch.native``) on the card's host.

    python3 bench_torch.py                 # on the card
    python3 bench_torch.py --device cpu    # the port's plain CPU path

Prints ONE JSON line last:
  {"metric": ..., "value": N, "unit": "columns/sec", "vs_baseline": N,
   "learn_s", "predict_users_per_sec", "predict_vs_baseline",
   "cpu_baseline_columns_per_sec", "cpu_predict_users_per_sec",
   "objective", "cpu_objective", "model_nnz", "ncols", "device",
   "cpu_baseline_threads"}
and, on an earlier line, the timed learns' minimum and maximum.

Learn: one warm-up learn (it builds the kernels), then SLIM_BENCH_REPS
timed learns; ``value`` is the median.  Predict: top-10 for every
training user with the model resident on the device (the serving
pattern: one model, many request batches), the best of three.  The
baseline is the native OpenMP CD solver at all cores (the reference
algorithm's per-column O(nnz) screen and sparse sweeps), and its
per-user top-N on the learned model.  The ML-20M baseline takes many
minutes, so it is cached in ``build/bench_torch_baseline.json``, keyed
by the workload's signature, the CPU count and the CPU model, and
measured again only when missing or under SLIM_BENCH_CPU=1.

Env knobs:
  SLIM_BENCH_SMALL=1   a synthetic ml100k-shaped workload (943 x 1,682,
                       100k ratings; live baseline)
  SLIM_BENCH_LARGE=1   a synthetic 50,000 x 10,000 workload (live baseline)
  SLIM_BENCH_CPU=1     measure the cached ML-20M baseline again
  SLIM_BENCH_REPS=n    timed learns (default 3)
"""

import argparse
import json
import logging
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

BASELINE_CACHE = os.path.join(HERE, "build", "bench_torch_baseline.json")

L1R, L2R = 1.0, 1.0
OPT_TOL = 1e-7
MAXNITERS = 10000
BLOCK_SIZE = 1024


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def load_workload():
    """(train CSR, name, whether it is the cached ML-20M workload).  The
    SMALL and LARGE items are drawn by ``datagen.zipf``, numpy 2.0's zipf
    stream, so each workload is the same matrix under any numpy."""
    from slim_tpu_torch.datagen import zipf
    from slim_tpu_torch.types import CSR

    rng = np.random.default_rng(0)
    if os.environ.get("SLIM_BENCH_SMALL") == "1":
        nrows, ncols, nnz = 943, 1682, 100000
        users = rng.integers(0, nrows, nnz)
        items = (zipf(rng, 1.3, nnz * 2) % ncols)[:nnz]
        vals = rng.integers(1, 6, nnz).astype(np.float32)
        return (CSR.from_ijv(users, items, vals, nrows, ncols),
                "synthetic-ml100k", False)
    if os.environ.get("SLIM_BENCH_LARGE") == "1":
        nrows, ncols, nnz = 50000, 10000, 2_000_000
        users = rng.integers(0, nrows, nnz)
        items = (zipf(rng, 1.25, nnz * 2) % ncols)[:nnz]
        mat = CSR.from_ijv(users, items, np.ones(nnz, np.float32),
                           nrows, ncols).binarize()
        return mat, "synthetic-50kx10k", False
    from slim_tpu_torch.datagen import synth_ml20m

    return synth_ml20m(seed=0), "ml20m-synth", True


def workload_sig(train):
    from slim_tpu_torch import native

    return {"nrows": train.nrows, "ncols": train.ncols,
            "nnz": int(train.nnz), "cpus": os.cpu_count(),
            "cpu_model": native.cpu_model(), "l1r": L1R, "l2r": L2R,
            "optTol": OPT_TOL}


def device_name(dev):
    """The card's name and power limit (nvidia-smi), or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_learn(train, repeats, dev):
    """(median learn s, model, stats, every timed learn's s)."""
    from slim_tpu_torch import SLIM_DBG_TIME, SlimConfig, learn

    # phase timings (gram / solve / harvest / assembly) to stderr, so a
    # recorded run carries its own breakdown
    logging.basicConfig(level=logging.INFO, format="[bench] %(message)s",
                        stream=sys.stderr)
    cfg = SlimConfig(l1r=L1R, l2r=L2R, optTol=OPT_TOL, maxniters=MAXNITERS,
                     block_size=BLOCK_SIZE, dbglvl=SLIM_DBG_TIME)
    t0 = time.perf_counter()
    learn(train, cfg, device=dev)
    sync(dev)
    log(f"[bench] warm-up learn {time.perf_counter() - t0:.2f}s")
    secs = []
    for r in range(repeats):
        t0 = time.perf_counter()
        model, stats = learn(train, cfg, device=dev)
        sync(dev)
        secs.append(time.perf_counter() - t0)
        log(f"[bench] learn repeat {r}: {secs[-1]:.3f}s")
    return statistics.median(secs), model, stats, secs


def bench_predict(train, model, dev, repeats=3):
    """Users/s of top-10 for every training user with the model resident
    on the device: dense W up to SPARSE_PREDICT_THRESHOLD, the padded
    rows above it; the best of ``repeats`` after a warm call."""
    from slim_tpu_torch.predict import (SPARSE_PREDICT_THRESHOLD,
                                        densify_model, predict_topn,
                                        sparsify_model_device)
    from slim_tpu_torch.solvers.cd import bucket_npad

    if bucket_npad(train.ncols) <= SPARSE_PREDICT_THRESHOLD:
        W = densify_model(model, device=dev)
    else:
        W = sparsify_model_device(model, device=dev)
    predict_topn(model, train, nrcmds=10, W_dev=W, device=dev)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        predict_topn(model, train, nrcmds=10, W_dev=W, device=dev)
        best = min(best, time.perf_counter() - t0)
    return train.nrows / best


def native_predict(train, model, repeats=3):
    """Users/s of the native per-user top-10 on ``model``, the best of
    ``repeats`` after a warm call."""
    from slim_tpu_torch import native

    native.predict_topn(model, train, nrcmds=10)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        native.predict_topn(model, train, nrcmds=10)
        best = min(best, time.perf_counter() - t0)
    return train.nrows / best


def bench_cpu(train, model, cached):
    """The native all-core baseline: {cols_per_s, obj, learn_s,
    predict_users_per_s, ...}; read from BASELINE_CACHE for the ML-20M
    workload when its signature matches, else measured (and cached)."""
    from slim_tpu_torch import native

    sig = workload_sig(train)
    if cached and os.environ.get("SLIM_BENCH_CPU") != "1":
        try:
            with open(BASELINE_CACHE) as fh:
                rec = json.load(fh)
            if rec.get("sig") == sig:
                log(f"[bench] cached native baseline "
                    f"({rec['cols_per_s']} cols/s, measured {rec['date']})")
                return rec
        except (OSError, ValueError, KeyError):
            pass
    log(f"[bench] native CPU baseline on {os.cpu_count()} cores "
        f"({sig['cpu_model']})...")
    t0 = time.perf_counter()
    _, _, obj = native.cd_learn(train, l1r=L1R, l2r=L2R, optTol=OPT_TOL,
                                maxniters=MAXNITERS, nthreads=0)
    dt = time.perf_counter() - t0
    rec = {"sig": sig, "cols_per_s": train.ncols / dt, "obj": obj,
           "learn_s": dt, "predict_users_per_s": native_predict(train, model),
           "date": time.strftime("%Y-%m-%d")}
    log(f"[bench] native learn {dt:.2f}s")
    if cached:
        os.makedirs(os.path.dirname(BASELINE_CACHE), exist_ok=True)
        with open(BASELINE_CACHE, "w") as fh:
            json.dump(rec, fh)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs the "
                         "port's plain CPU path)")
    args = ap.parse_args(argv)
    from slim_tpu_torch.ops.gram import pin_f32
    from slim_tpu_torch.utils import resolve_device

    dev = resolve_device(args.device)
    pin_f32()
    t0 = time.perf_counter()
    train, name, cached = load_workload()
    train = train.infer_ncols()
    log(f"[bench] workload {name}: {train.nrows}x{train.ncols} "
        f"nnz={train.nnz} (gen {time.perf_counter() - t0:.1f}s)")

    reps = int(os.environ.get("SLIM_BENCH_REPS", "3"))
    learn_s, model, stats, secs = bench_learn(train, reps, dev)
    print(f"learn: min {min(secs)} s, max {max(secs)} s, median {learn_s} s "
          f"over {reps} timed learns", flush=True)
    users_ps = bench_predict(train, model, dev)
    log(f"[bench] predict {users_ps:.0f} users/sec")
    cpu = bench_cpu(train, model, cached)
    cpu_cps, cpu_ups = cpu["cols_per_s"], cpu["predict_users_per_s"]
    log(f"[bench] native CPU predict {cpu_ups:.0f} users/sec")
    cps = train.ncols / learn_s
    print(json.dumps({
        "metric": f"{name}_cd_item_columns_per_sec",
        "value": cps,
        "unit": "columns/sec",
        "vs_baseline": cps / cpu_cps,
        "learn_s": learn_s,
        "predict_users_per_sec": users_ps,
        "predict_vs_baseline": users_ps / cpu_ups,
        "cpu_baseline_columns_per_sec": cpu_cps,
        "cpu_predict_users_per_sec": cpu_ups,
        "objective": stats["loss"],
        "cpu_objective": cpu["obj"],
        "model_nnz": model.nnz,
        "ncols": train.ncols,
        "device": device_name(dev),
        "cpu_baseline_threads": os.cpu_count(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
