"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # everything, as a release check runs it
    python3 chip_smoke.py --only kernels   # build + kernel-vs-plain checks
    python3 chip_smoke.py --only dist      # phase 4's learn + phase 13
    python3 chip_smoke.py --only native    # phases 3, 3b, 4, 7 + phase 14
    python3 chip_smoke.py --only cli       # the three programs (phase cli)
    python3 chip_smoke.py --profile chiprun_out   # one sweep and phase 4
                                                  # under torch.profiler

Phases (any failure exits non-zero, and no result line is printed):
  1. card name and power limit (nvidia-smi); build the CUDA kernels and
     the native host runtime (g++; a missing compiler fails the run).
  2. (after the ML-20M synth matrix is generated, in phase "datagen")
     each kernel against its plain PyTorch version on the card, at the
     main path's shapes: densify (npad 28672, the TPU kernel's (W, R)
     layout, a fresh block) into float32 and int8, and into bfloat16
     (``densify_bf16``, the dense predict's histories above npad 8192;
     integer values 1-5 with duplicates, exact; a column of 256, 1 and 1
     must give 258: one rounding, as the TPU kernel's), and the whole
     ``densify_runs`` call at the ML-20M Gram's first block (int8) and the
     "high" predict's first user block (bfloat16), each against its plain
     version, exact (``extra``: densify@gram_ml20m,
     densify_bf16@hist_ml20m), the whole-array row-major
     sweep (B 512 at npad 384, the synth path's, and 4096, the ML-1M
     path's), the coordinate-major sweep at B 1024, npad 28672, one sweep
     with every group active (phase 4's shape) and with 38 of 56 groups
     active, the row-major deferred-flush sweeps v3 and eager at the same
     two, pack (1024, 28672); then phase 7's compact FSLIM blocks, each
     column on its 50 cosine neighbours and ``has`` as the solver builds
     it: the whole-array sweep at B 1024, npad 2048 and 4096, and the
     coordinate-major sweep at B 1024, npad 8192; and a packed grid block
     that straddles two points (half the columns at l1r = l2r = 2 with a
     cap of 40, half at 1 with 60, each screened at its own l1r, the cap
     reached in the sweep) on the whole-array sweep at B 512, npad 4096,
     and on the coordinate-major sweep at B 1024, npad 28672, 38 of 56
     groups active; the compact block's gathers (``gather``: G[S, S] and
     the targets' G[S, j], B 1024) at phase 7's widest FSLIM union (npad
     28672, K 8192) and at Amazon-Book's widest compact union (npad 94208,
     K 61440), bit for bit against two ``index_select``s (``extra``:
     gather@fslim_trans, gather@amzbook, gather@amzbook_trans).  The
     coordinate-major sweep's window flush alone at
     the ML-20M shape (B 1024, npad 28672, 56/56) on a random normal G:
     one window on a q ~100 times its increment against its plain version
     (1e-5 of the increment plus 2 ulps of q), then the 14 windows of a
     sweep timed by CUDA events beside their bound (bf16x3 operations at
     989 TFLOP/s against bytes at 3.35 TB/s), the ``flush:`` line; and its TMA ring
     alone (``feed_only``: no product, no q), the ``flush feed:`` line,
     with the bytes it stages from L2 a second and the product rate that
     feed could carry.  Each check line gives the
     max error, the kernel's and the plain version's times, the bound (the
     larger of the bytes the function must move over 3.35 TB/s and its
     operations over the peak of their type) with what sets it, the
     kernel's share of it, and the time of the one PyTorch call that
     computes the same function: ``index_put_`` with accumulate for
     densify (into a bfloat16 buffer for densify_bf16), ``masked_select``
     + ``nonzero`` for pack (the harvest's
     offsets are contiguous).  With --profile DIR, one sweep of each wide-block
     variant (v4, v3, eager; all active, then 38/56) runs under
     torch.profiler; its device time by kernel goes to
     DIR/profile_sweep.json.
  3. the vendored synth set through learn / get_topn: the quality goldens.
  3b. a MovieLens-1M-shaped learn (datagen.synth_implicit(6040, 3706,
     1000209, seed=0), nothing downloaded): npad 4096, so every block
     solves on the whole-array sweep; predict top-10 for every user.
     Objective and model nnz against the JAX package's result on the same
     matrix; the first 256 users' ids against the CPU path.
  cli. the three programs, slim_learn, slim_predict and slim_mselect, in
     this process through their main(argv) with no -device (the card), on
     csr files at the ML-1M shape: the training matrix with a repeated
     event in every 10th user (at a random position of its row: unsorted,
     with a duplicate), a held-out draw as the test file.  The reader's
     matrix equals scipy's sum over the same triplets (the oracle);
     slim_learn (l1r = l2r = 1, ML1M_CFG) within 1e-6 rel of api.learn's
     objective on the oracle, model nnz equal; slim_predict's top-10 on
     its model file against predict_topn of the API's model on the oracle
     (``check_agree``), its printed HR / ARHR those of its own lists and
     of the API's lists but at the users whose lists differ; slim_mselect
     over MSELECT_POINTS: the best pair and its HR those of mselect_pairs
     on the oracles.  The programs' results are read from their own calls
     (``recording``) and their printed lines checked against them.  Only
     the programs run while the launch counters count (``run_cli``); the
     API references run after the counts are read (``check_cli``).  One
     ``cli:`` line: read s (the file with repeats, and without), each
     program's s, objective, nnz, HR, ARHR, and the card.
  3c. FSLIM (nnbrs 50, cos, the JAX package's golden settings) at the
     ML-1M shape, at full width and with compact_threshold 2048 (every
     block on its FSLIM union): both against the JAX package's objective
     and nnz on JAX-CPU, every column on at most 50 coordinates.
  4. the ML-20M synth workload at full scale (generated once, shared by
     phases 4-7): learn -> predict_topn for every user, unpinned (the
     dense route at "high": npad 28672 is above the npad-8192 rule);
     objective and model nnz against the JAX package's result.  Then the
     same users with the model on the card at "high", "highest" and
     "default", two rounds in turns (each its least; users/s printed):
     "high" against "highest" with every score within 2^-16 rel, and
     held as two routes are (``check_agree``: the same counts, scores
     within 1e-5 rel, ids equal but at near ties, a user the rule cannot
     forgive held to the scipy oracle on both lists), its first 512 users
     against the scipy oracle; "default" within 2^-7 rel (its differing
     ids printed, not gated: the JAX package's own trade).  Last, the
     model densified row-major (``predict.densify_model``) against the
     transposed densify plus a transpose copy, in turns, equal.  The learn
     keeps its blocks' entries on the card and assembles the model there
     (``assembly`` "card").  After the phase's launch counts are read,
     the same learn runs again, its held blocks also assembled by
     ``native.csr_from_blocks`` on the host, and once more with its
     entries moved to host memory at block 1 (the card's budget patched,
     ``assembly`` "host"); phase 4's model, the native one and the moved
     learn's are equal entry for entry, the objective bit-equal; one
     ``ml20m harvest:`` line gives each run's learn_s, phases (the wait
     solve-sync among them) and ``assembly``.  With --profile DIR the
     learn and predict run under torch.profiler; device time by kernel
     and the device idle share (the union of the device rows' intervals)
     go to DIR/profile_ml20m.{txt,json}.
  5. model selection (mselect_pairs) over (2, 2) -> (1, 1) with
     SLIM_PALLAS_V4=0, so every wide block takes the v3 sweep; the test set
     is a held-out draw with the same popularity law.  The warm (1, 1)
     point must reach phase 4's objective and nnz gates in fewer
     column-iterations than phase 4's cold learn, and each point's retained
     device pack must densify to its model.
  6. one cold learn with SLIM_PALLAS_V3=0 SLIM_PALLAS_V4=0 (the eager
     sweep), held to the same gates.
  7. FSLIM (nnbrs 50, cos) at full ML-20M scale on the compact path:
     learn s, phases, sweeps, union widths; every column on at most 50
     coordinates; union exactness (256 targets' full-width neighbour sets
     inside their block's union, each support inside its set); the same
     learn with SLIM_COMPACT_FRAC=0 (every block at npad 28672 on v4) to
     the objective rtol 1e-4, nnz 1%.  Then the model served: dense
     top-10 for every user; the dense, score-row and COO routes timed on
     the first 16,384 users, the model on the card in each; for the first
     4,096 users sparse and COO top-N against dense, and 1-vs-k and
     candidate scores (held-out items of phase 5's test set + 100
     negatives) on the dense, sparse and COO routes against each other
     (ids equal but at the near ties ``checks.ranked_mismatches``
     forgives).
  8. the 262,144-item serving workload of scripts/predict_large_bench.py
     (100,000 users): top-10 by sparse score rows (the only route: a dense
     W would be 283 GB) and by COO, in agreement; the first 1,024 users
     against a scipy oracle (``checks.topn_oracle_mismatches``); users/s
     of both.
  9. ADMM through api.learn at scripts/admm_bench.py's regime (500,000
     users x 4,096 items, ~12.7M nnz, l1r = l2r = 2): W against the card's
     float64 version (atol 2e-2, fit within 1e-3 rel), zero diagonal,
     W > 0; factor and iterations timed against the iteration's FP32
     bound; then the ML-1M shape against the JAX package's objective and
     nnz.
  10. mselect_grid(parallel=True) at the ML-1M shape over l1 in {0.5, 1,
     2} x l2 in {1, 2} (test set a held-out draw): each point against a
     cold learn of it on the card, (1, 1) against the JAX package's, HR /
     ARHR against the sequential walk's, the same best pair; cols/s of the
     packed pass and of the walk.  After the counts are read,
     estimate_grid_cd over the same points with its entries held on the
     card and moved to host memory at the first block, every point equal
     entry for entry (``grid harvest:``, each pass's seconds and
     phases).
  10b. estimate_grid_cd over (2, 2), (1, 1) on the ML-20M matrix (v4):
     (1, 1) against the JAX package's, (2, 2) against phase 5's cold point;
     its phases printed.
  11. the ML-20M learn with checkpoint_dir (a temporary directory): equal
     to phase 4 within the gates; a third of the block files deleted and
     the learn resumed, its sweeps and packs those of the deleted blocks
     only, each re-solved block within CKPT_RESOLVE_ATOL of its first
     solve; a full restore launches no sweep and no pack; the directory
     removed.  The block files are written in block order in the phase
     ``checkpoint`` (``write_s``: its seconds).
  12. the SLIM / SLIMatrix classes at the ML-1M shape from (user, item,
     rating) triplets: train -> predict (no device given) -> save_model /
     load_model -> predict, against api.learn + get_topn, the matrix's ids
     uploaded to the card once; a learn with profile_dir writes a trace
     that names the sweep kernel.
  guide. the walkthrough docs/userguide_torch.py (every public entry
     point, sections 1-9) on cuda:0 at its guide shape (docs/userguide.py's
     120 x 60 data; every fit, HR / ARHR and mselect point against the JAX
     package's, GUIDE_*) and at the ML-1M shape (the class model against
     the functional learn, the distributed learns against phase 3b); each
     section's wall time and launches printed (run_guide).
  13. the distributed learns (slim_tpu_torch.parallel), in spawned worlds
     of one process per rank (parallel.launch.run_world), each rank
     counting its own launches.  A NCCL world of torch.cuda.device_count()
     ranks: dist_ml1m, the replicated, blockwise and sharded-G learns and
     mselect_grid(parallel=True, mesh=) at the ML-1M shape (no route
     pinned: rank 0 scores every point on a device route, the other ranks
     none); dist_ml20m, the
     replicated and sharded-G learns and the sharded predict (every user)
     at ML-20M, each learn within DIST_OBJ_RTOL of phase 4's objective and
     DIST_NNZ_RTOL of its nnz and within the ML-20M gates, the first 4,096
     users' ids against the single-device predict of the same model;
     dist_2m, the blockwise learn at scripts/amazon2m_dryrun.py's 2M-item
     shape (datagen.synth_longtail: 50,000 x 2,000,000, 400k draws,
     block_size 64, l1r = l2r = 0.5, shuffle off) against the JAX
     package's objective there.  Then dist_gloo2, dist_ml1m again in a
     2-rank gloo world on cuda:0 (collectives staged through the host),
     against the NCCL world's results.  Every rank of a world returns the
     same model.  Each learn prints its seconds, cols/s, objective and nnz.
  14. the native host runtime (slim_tpu_torch.native) on the card's host:
     its build seconds and the CPU count; native.cd_learn on the synth set
     against its goldens, and at the ML-1M shape against the JAX package's
     objective and nnz when the synth time scaled by columns x ratings
     predicts it within 60 s (else a line says it was left out); phase 4's
     model cut into 27 shuffled COO fragments and assembled through
     native.csr_from_blocks (the native counting sort) and through
     solvers.cd._assemble on the card (the learn's assembly), both equal
     to the model entry for entry, both timed; the native predict
     route against the card's dense route (the model densified in the
     call, and resident) on the synth set, the ML-1M shape, the ML-20M
     FSLIM model (every user), the first 16,384 users of phase 4's model,
     and at the route's crossover (the ML-1M shape's model cut to its
     first 383, 767 and 1,535 items, and the first 600 users of those,
     of the ML-1M shape and of the FSLIM model): the same counts, scores
     within 1e-5 rel, ids equal up to the order within runs of equal
     scores, users/s of both and the route an unpinned call takes, which
     must be the faster one wherever they differ by more than 1.25x (the
     check comes last in the phase); native.gram_dense at the
     ML-1M shape equal to the card's Gram; both tokenisers on the ML-1M
     shape written as a csr file.  After the phase's launch counts are
     read, the CD learn on the card at a synthetic ml100k shape
     (``check_cd_small``), its objective within 1e-4 rel of the native
     CPU solver's.  Every earlier phase pins its predict
     route (``sparse=``, ``W_dev`` or SLIM_PREDICT_NATIVE_NPAD=0 around a
     call that takes neither), so it measures the route it measured before
     the native route was added; phase 4's top-N is unpinned and must stay
     on the card, the guide's unpinned calls take the route the router
     picks, and the mesh grid of phase 13 pins its own device route.
  15. the kernels line.  Phases 3-14 (3b, cli, 3c, 10b and guide too) are each
     driven with every launch counter set to 0 just before and read just
     after (in the ranks, summed over them, for phase 13's paths; the
     guide's section-9 ranks are printed apart); each path
     must launch its own kernels (PATH_KERNELS) and no other (phase 8: no
     kernel at all).  A kernel's
     ``launches`` is the sum of its per-path counts (``launches_by_path``)
     (a ``launches`` line whose path ran the coordinate-major sweep also
     gives ``cd_sweep_large.flush_launches``, its window flushes)
     in the unit of ``launch_unit``; errors and times come from phase 2, at
     the shape the path runs (``ms``/``plain_ms``) and at the other shapes
     checked (``extra``).
Each phase's wall time is printed.  On its way out, after a failure
too, the script stops and reaps every process it started
(``stop_children``).  The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# quality goldens of the vendored synth set (tests/test_goldens.py)
SYNTH_LOSS, SYNTH_NNZ, SYNTH_HR, SYNTH_ARHR = 4730.0005, 10613, 0.230833, 0.135996
# ML-20M synth (datagen.synth_ml20m(seed=0), l1r = l2r = 1): the JAX
# package's objective and model nnz
ML20M_OBJ, ML20M_NNZ = 9415007.30, 34464838
ML20M_CFG = dict(optTol=1e-7, maxniters=10000, block_size=1024)
# MovieLens-1M's shape (GroupLens' ML-1M README: 6,040 users, 3,706 rated
# movies, 1,000,209 ratings), l1r = l2r = 1: the JAX package's objective
# and model nnz on JAX-CPU (204 sweeps), from
#   JAX_PLATFORMS=cpu python -c "from slim_tpu import api;
#     from slim_tpu.config import SlimConfig;
#     from slim_tpu.datagen import synth_implicit;
#     print(api.learn(synth_implicit(6040, 3706, 1_000_209, seed=0),
#       SlimConfig(l1r=1.0, l2r=1.0, optTol=1e-7, maxniters=10000,
#                  block_size=512))[1])"
ML1M_SHAPE = (6040, 3706, 1_000_209)
ML1M_OBJ, ML1M_NNZ = 388952.659, 886847
ML1M_CFG = dict(optTol=1e-7, maxniters=10000, block_size=512)
MSELECT_POINTS = [(2.0, 2.0), (1.0, 1.0)]
# ADMM at scripts/admm_bench.py's regime: 500,000 users x 4,096 items, 20M
# draws of zipf(1.25) from default_rng(0), binarised (~12.7M nnz)
ADMM_SHAPE = dict(nrows=500_000, ncols=4096, draws=20_000_000, a=1.25)
ADMM_CFG = dict(algo="admm", l1r=2.0, l2r=2.0)
# ADMM at MovieLens-1M's shape, l1r = l2r = 1: the JAX package's objective
# and model nnz on JAX-CPU, from
#   JAX_PLATFORMS=cpu python -c "from slim_tpu import api;
#     from slim_tpu.config import SlimConfig;
#     from slim_tpu.datagen import synth_implicit;
#     print(api.learn(synth_implicit(6040, 3706, 1_000_209, seed=0),
#       SlimConfig(algo='admm', l1r=1.0, l2r=1.0))[1])"
ML1M_ADMM_OBJ, ML1M_ADMM_NNZ = 392990.4375, 1778195
# checkpoint resume (phase 11): the largest difference allowed between a
# re-solved block's values and its first solve's (both on the card, same
# seed, same kernels)
CKPT_RESOLVE_ATOL = 0.0
# the packed grid at the ML-1M shape (phase 10) and at ML-20M (10b)
GRID_L1, GRID_L2 = (0.5, 1.0, 2.0), (1.0, 2.0)
GRID_ML20M = [(2.0, 2.0), (1.0, 1.0)]
# FSLIM: the JAX package's golden settings (tests/test_goldens.py:151-165);
# at MovieLens-1M's shape its objective and model nnz on JAX-CPU (151
# sweeps), from
#   JAX_PLATFORMS=cpu python -c "from slim_tpu import api;
#     from slim_tpu.config import SlimConfig;
#     from slim_tpu.datagen import synth_implicit;
#     print(api.learn(synth_implicit(6040, 3706, 1_000_209, seed=0),
#       SlimConfig(l1r=1.0, l2r=1.0, nnbrs=50, simtype='cos', optTol=1e-7,
#                  maxniters=10000, block_size=512))[1])"
FSLIM_CFG = dict(l1r=1.0, l2r=1.0, nnbrs=50, simtype="cos")
ML1M_FSLIM_OBJ, ML1M_FSLIM_NNZ = 414806.0915, 103225
# the serving workload of scripts/predict_large_bench.py: 262,144 items,
# 100,000 users, 50 model entries per row on zipf(1.3) columns, 40-entry
# zipf(1.2) histories, seed 7 (npad 266,240: a dense W would be 283 GB)
SERVE_SHAPE = dict(n=262_144, nusers=100_000, nnz_row=50, hlen=40, seed=7)
# the distributed learns (phase 13): each within DIST_OBJ_RTOL of the
# single-device objective of the same matrix in this run (phase 4 at
# ML-20M, the NCCL world's at the ML-1M shape) and within DIST_NNZ_RTOL of
# its model nnz; the sharded predict against the single-device predict on
# the first DIST_HEAD users
DIST_OBJ_RTOL, DIST_NNZ_RTOL, DIST_HEAD = 1e-6, 1e-4, 4096
# the 2M-item blockwise learn of scripts/amazon2m_dryrun.py: its config
# and the JAX package's objective there (docs/RESULTS.md:592; the native
# oracle gives 147,401.170)
DIST_2M_CFG = dict(l1r=0.5, l2r=0.5, block_size=64, shuffle=False)
AMAZON2M_OBJ = 147401.176
# the walkthrough docs/userguide_torch.py at its guide shape (120 users x
# 60 items from default_rng(0), docs/userguide.py's data): the JAX
# package's results on JAX-CPU on the same matrices, which
# tests/test_torch_userguide.py holds to slim_tpu.  (loss, nnz) of the
# class train (section 2), FSLIM and ADMM (6), the functional learn (7)
# and section 9's config (l1r = l2r = 1) on one device; HR / ARHR of the
# functional learn; the mselect walk's (l1r, l2r, nnz, HR, ARHR) per point
# (5); the best pairs (l1 HR, l2 HR, l1 ARHR, l2 ARHR) of the walk and of
# the packed grid
GUIDE_FITS = {"train": (4218.0137367248535, 1097),
              "fslim": (4333.907215118408, 581),
              "admm": (4480.16650390625, 1900),
              "functional": (4218.0137367248535, 1097),
              "dist": (4256.552139282227, 1091)}
GUIDE_EVAL = (0.09916666666666665, 0.04651732566407575)
GUIDE_MSELECT = [(0.1, 0.5, 1100, 0.06377551020408162, 0.04640074211502782),
                 (0.1, 2.0, 1106, 0.06377551020408162, 0.04640074211502782),
                 (1.0, 0.5, 1089, 0.06377551020408162, 0.04640074211502782),
                 (1.0, 2.0, 1096, 0.06377551020408162, 0.04640074211502782)]
GUIDE_BEST = (0.1, 0.5, 0.1, 0.5)
# the kernels each driven path must launch, and no other: the synth set (npad
# 384) and the ML-1M shape (npad 4096) solve on the whole-array row-major
# sweep, and so do both ML-1M FSLIM learns (full width, and compact with every
# union at most 2,048 wide, its pieces gathered by the gather kernel); every
# ML-20M block on the wide-block sweep its variant picks (v4 by default, v3
# and eager under the env switches; every union full width, so no gather); the
# ML-20M FSLIM learns on the whole-array sweep (compact blocks whose union is
# 4,096 or less, gathered) and on v4 (wider unions, gathered, and every block
# of the SLIM_COMPACT_FRAC=0 learn); the 262k-item serving phase scores sparse
# and launches none; ADMM's products are plain matmuls (its Gram goes through
# densify); the packed grids and the classes solve as the learns of their
# shapes do.  The dense predicts above npad 8192 that name no precision
# (phases 4, 5, 7 and 14 at ML-20M) score at "high", their histories densified
# into bfloat16 (densify_bf16)
PATH_KERNELS = {"synth": ("densify", "cd_sweep", "pack"),
                "ml1m": ("densify", "cd_sweep", "pack"),
                # the three programs at the ML-1M shape: the learns' Grams
                # and the dense predicts on densify, their blocks on the
                # whole-array sweep (npad 4096), harvests on pack
                "cli": ("densify", "cd_sweep", "pack"),
                "ml1m_fslim": ("densify", "cd_sweep", "pack", "gather"),
                "ml20m": ("densify", "densify_bf16", "cd_sweep_large",
                          "pack"),
                "mselect": ("densify", "densify_bf16", "cd_sweep_v3",
                            "pack"),
                "eager": ("densify", "cd_sweep_eager", "pack"),
                "fslim": ("densify", "densify_bf16", "cd_sweep",
                          "cd_sweep_large", "pack", "gather"),
                "serve": (),
                "admm": ("densify",),
                "grid": ("densify", "cd_sweep", "pack"),
                "grid_ml20m": ("densify", "cd_sweep_large", "pack"),
                "checkpoint": ("densify", "cd_sweep_large", "pack"),
                "api": ("densify", "cd_sweep", "pack"),
                # the walkthrough: both shapes on the whole-array sweep
                # (npad 64 and 4096), Grams, warm starts and the dense
                # predict on densify, harvests on pack; ADMM's Gram too
                "guide": ("densify", "cd_sweep", "pack"),
                # the distributed paths: the ML-1M shape's blocks and
                # superblock unions (at most 4,096 wide) on the whole-array
                # sweep, ML-20M's (unions 24,576-28,672 wide) on v4, the
                # 2M-item unions (about 2,000 hot items) on the whole-array
                # sweep; Grams, screens and the dense predict on densify
                "dist_ml1m": ("densify", "cd_sweep", "pack"),
                "dist_ml20m": ("densify", "cd_sweep_large", "pack"),
                "dist_2m": ("densify", "cd_sweep", "pack"),
                "dist_gloo2": ("densify", "cd_sweep", "pack"),
                # phase 14: the card's dense predict and Gram beside the
                # host's (densify, densify_bf16 for the ML-20M models);
                # no solve on the card
                "native": ("densify", "densify_bf16")}
WIDE_SWEEPS = ("cd_sweep_large", "cd_sweep_v3", "cd_sweep_eager")
_SWEEP_UNIT = ("sweeps: one wrapper call enqueues, per 128-wide chunk of "
               "the visit order, a group kernel (GS chain) and a "
               "tensor-core flush, and an end-of-sweep kernel")
_LARGE_UNIT = ("sweeps: one wrapper call enqueues, per group of the visit "
               "order, a q-tile load and a group kernel (GS chain + in-group "
               "tensor-core product), a tensor-core flush per window with "
               "work, and an end-of-sweep kernel")
_PANEL_UNIT = ("sweeps: one wrapper call enqueues, per group of the visit "
               "order, a group kernel (GS chain + in-group tensor-core "
               "product) and, at a v3 window's slots after the first, a "
               "q-tile load; a tensor-core flush per window with work, and "
               "an end-of-sweep kernel")
_DENSIFY_UNIT = ("kernel launches: one per densify / densify_runs call, "
                 "whatever the block's size or its longest run")
LAUNCH_UNIT = {"densify": _DENSIFY_UNIT, "densify_bf16": _DENSIFY_UNIT,
               "pack": "kernel launches",
               "gather": "kernel launches: one per gather call (a compact "
                         "block's G[S, S] or its targets' G[S, j])",
               "cd_sweep": _SWEEP_UNIT, "cd_sweep_large": _LARGE_UNIT,
               "cd_sweep_v3": _PANEL_UNIT, "cd_sweep_eager": _PANEL_UNIT}


# H100 SXM peaks (NVIDIA's data sheet): memory rate, the tensor-core TF32
# rate for float32 products (the sweeps' operands are float32), and the
# FP32 rate off the tensor cores (ADMM's products, TF32 off)
HBM_BPS = 3.35e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12    # dense bf16 tensor-core rate (the flush's products)


def bound(nbytes, flops=0.0, peak=TF32_FLOPS):
    """Least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over ``peak``, and which one."""
    tb, to = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def with_bound(line, nbytes, flops=0.0, library_ms=None):
    ms, by = bound(nbytes, flops)
    line.update(bound_ms=ms, bound_by=by, share=ms / line["ms"],
                library_ms=library_ms)
    return line


def group_sweep_work(npad, B, has):
    """(bytes, FLOP) of one group sweep (v4 / v3 / eager contract) for this
    visit order's ``has``.  FLOP per active group: its deltas reach all
    npad rows of q once (2 * B * npad * 512) and the GS chain (a 128-wide
    triangle per sub-chunk).  The window-load corrections and in-group
    products only bring forward contributions the flush also makes, so
    they are not part of the work the outputs need.  Bytes: the active
    groups' G rows once, gj/act/x/q in, x/q out."""
    grp, ch = 512, 128
    na = sum(int(h) for h in has)
    flops = na * (2.0 * B * npad * grp + B * ch * ch * (grp // ch))
    nbytes = 4.0 * grp * npad * na + B * npad * (13.0 + 8.0)
    return nbytes, flops


PR_SET_CHILD_SUBREAPER = 36    # linux/prctl.h


def adopt_orphans() -> None:
    """Make this process the parent of its descendants whose own parent
    ends first (Linux's child subreaper), so :func:`stop_children` finds
    them too."""
    ctypes.CDLL(None, use_errno=True).prctl(PR_SET_CHILD_SUBREAPER, 1, 0,
                                            0, 0)


def _children() -> list[int]:
    me = str(os.getpid())
    kids = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = f.read().rsplit(")", 1)[1].split()[1]
        except OSError:        # the process ended meanwhile
            continue
        if ppid == me:
            kids.append(int(d))
    return kids


def stop_children(grace_s: float = 5.0) -> list[int]:
    """Stop and reap every process this one started that is still there,
    so that the run leaves none behind: multiprocessing's resource tracker
    (started by the first spawned world, it lives until its parent ends)
    is closed and waited for as multiprocessing closes it, and any other
    child is sent SIGTERM, then SIGKILL after ``grace_s``.  Returns the
    pids of those others, each also named on stderr."""
    from multiprocessing import resource_tracker

    resource_tracker._resource_tracker._stop()
    strays = _children()
    for pid in strays:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            cmd = "?"
        print(f"chip_smoke: stopping leftover process {pid}: {cmd[:200]}",
              file=sys.stderr, flush=True)
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGTERM)
    deadline = time.monotonic() + grace_s
    for pid in strays:
        with contextlib.suppress(ChildProcessError):   # reaped meanwhile
            while os.waitpid(pid, os.WNOHANG) == (0, 0):
                if time.monotonic() > deadline:
                    os.kill(pid, signal.SIGKILL)
                    os.waitpid(pid, 0)
                    break
                time.sleep(0.05)
    return strays


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def once_ms(fn):
    """(fn(), its milliseconds by CUDA events): one call, for the plain
    versions, each of which takes up to seconds and serves as the
    reference of the same check."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


@contextlib.contextmanager
def env(**values):
    """Set environment variables for the block; restore them after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_gates(tag, stats):
    """The ML-20M quality gates: objective and model nnz."""
    check(abs(stats["loss"] - ML20M_OBJ) <= 1e-4 * ML20M_OBJ,
          f"{tag} objective {stats['loss']}")
    check(abs(stats["nnz"] - ML20M_NNZ) <= 0.01 * ML20M_NNZ,
          f"{tag} model nnz {stats['nnz']}")


def check_densify(dev, rng, trn):
    """The densify lines: float32 (with the int8 output's error) and
    bfloat16, each timed with its plain version and its library call, at
    the TPU kernel's (W, R) layout; then the whole ``densify_runs`` call at
    two of the main path's blocks of ``trn`` (ML-20M)."""
    from slim_tpu_torch.ops.densify import densify, densify_meta, densify_plain

    npad, W, R = 28672, 256, 8192
    lens = rng.integers(0, W + 1, R)
    ids = rng.integers(0, npad, (W, R)).astype(np.int32)
    ids[np.arange(W)[:, None] >= lens[None, :]] = npad      # sentinels
    ids[1, ::7] = ids[0, ::7]                               # duplicates
    vals = rng.integers(1, 6, (W, R)).astype(np.float32)    # exact sums
    idsT = torch.from_numpy(ids).to(dev)
    valsT = torch.from_numpy(vals).to(dev)
    wmax = densify_meta(idsT, npad)
    # the one library call: index_put_ with accumulate on flat indices of
    # the entries that pass the mask (the masking is done beforehand)
    ok = (idsT >= 0) & (idsT < npad)
    rr = torch.arange(R, device=dev).expand(W, R)
    flat = (idsT.long() * R + rr)[ok]
    lines = []
    for name, dt, kinds in (
            ("densify", torch.float32, ((valsT, torch.float32),
                                        (None, torch.int8))),
            ("densify_bf16", torch.bfloat16, ((valsT, torch.bfloat16),))):
        err = 0.0
        for v, odt in kinds:
            got = densify(idsT, v, wmax, npad, out_dtype=odt)
            ref = densify_plain(idsT, v, wmax, npad,
                                torch.zeros((npad, R), dtype=odt, device=dev))
            err = max(err, (got.float() - ref.float()).abs().max().item())
        check(err == 0.0, f"{name} differs from plain by {err}")
        # the timed call writes a fresh block, zeros included
        ms = cuda_ms(lambda: densify(idsT, valsT, wmax, npad, out_dtype=dt),
                     10)
        plain_ms = cuda_ms(lambda: densify_plain(
            idsT, valsT, wmax, npad,
            torch.zeros((npad, R), dtype=dt, device=dev)), 3)
        v = valsT[ok].to(dt)
        out = torch.zeros(npad * R, dtype=dt, device=dev)
        library_ms = cuda_ms(
            lambda: out.index_put_((flat,), v, accumulate=True), 10)
        line = dict(name=name, route="cuda",
                    source="slim_tpu_torch/csrc/densify.cu",
                    replaces="slim_tpu/ops/pallas_gram.py:58",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    shape=f"W={W} R={R} npad={npad}", tol="exact")
        # ids and values read once, the dense block written once
        lines.append(with_bound(line, 8.0 * W * R + dt.itemsize * npad * R,
                                library_ms=library_ms))
    # bfloat16 sums round once, as the TPU kernel casts its f32 tile: a
    # column of 256, 1 and 1 is 258 (256 when rounded after each entry)
    ids1 = torch.full((4, 256), npad, dtype=torch.int32, device=dev)
    v1 = torch.zeros((4, 256), device=dev)
    ids1[:3, 7] = 5
    v1[:3, 7] = torch.tensor([256.0, 1.0, 1.0])
    got = densify(ids1, v1, densify_meta(ids1, npad), npad,
                  out_dtype=torch.bfloat16)[5, 7].item()
    check(got == 258.0, f"densify_bf16 gave {got} for 256 + 1 + 1")
    lines += [check_densify_runs(dev, trn, *blk)
              for blk in densify_blocks(trn)]
    return lines


def densify_blocks(trn):
    """(name, runs, n_valid, dtype) of two densify_runs calls of the main
    path on the ML-20M matrix: the Gram's first block as
    ``ops.gram.gram_partial`` takes it (the longest rows, nnz-sorted, the
    block padded with empty rows to an RT multiple; int8 out) and the first
    user block of the dense predict at "high" (``predict._user_block``
    users of the longest histories; bfloat16 out, ids >= ncols dropped)."""
    from slim_tpu_torch.ops.gram import RT, WCAP, _row_block, pow2_width
    from slim_tpu_torch.predict import _user_block
    from slim_tpu_torch.solvers.cd import bucket_npad

    npad = bucket_npad(trn.ncols)
    row_nnz = trn.row_nnz().astype(np.int64)
    order = np.argsort(-row_nnz, kind="stable")
    take = min(_row_block(min(pow2_width(row_nnz[order[0]]), WCAP)),
               trn.nrows)
    R = max(-(-take // RT) * RT, RT)
    gram = np.zeros((2, R), np.int64)
    gram[0, :take] = trn.indptr[order[:take]]
    gram[1, :take] = row_nnz[order[:take]]
    users = order[:_user_block(npad, 1024)]
    return (("densify@gram_ml20m", gram, None, torch.int8),
            ("densify_bf16@hist_ml20m",
             np.stack([trn.indptr[users], row_nnz[users]]), trn.ncols,
             torch.bfloat16))


def check_densify_runs(dev, trn, name, runs, n_valid, dt):
    """One densify_runs call of the main path (what its caller pays: the
    runs' upload, the fresh block and the kernel) against its plain
    version (exact: binary data) and ``index_put_`` with accumulate into a
    zeroed block; the bound counts each id read once, the run table (12
    bytes a run) and the block written once."""
    from slim_tpu_torch.ops.densify import densify_runs, densify_runs_plain
    from slim_tpu_torch.solvers.cd import bucket_npad

    npad = bucket_npad(trn.ncols)
    idx = trn.dev_put("idx32", lambda: trn.indices.astype(np.int32), dev)
    rs, rl = runs
    R = rs.size

    def call(fn):
        return fn(idx, None, rs, rl, npad, n_valid, torch.empty(
            (npad, R), dtype=dt, device=dev))

    got = call(densify_runs)
    ref, plain_ms = once_ms(lambda: call(densify_runs_plain))
    err = (got.float() - ref.float()).abs().max().item()
    check(err == 0.0, f"{name} differs from plain by {err}")
    del got, ref
    ms = cuda_ms(lambda: call(densify_runs), 10)
    # the library call: the entries' flat positions c * R + r (kept ids
    # only, computed beforehand), ones added by index_put_
    r = torch.from_numpy(np.repeat(np.arange(R), rl)).to(dev)
    e = torch.from_numpy(np.concatenate(
        [np.arange(s, s + n) for s, n in zip(rs, rl)])).to(dev)
    c = idx[e].long()
    keep = c < (npad if n_valid is None else n_valid)
    flat = (c * R + r)[keep]
    ones = torch.ones(flat.numel(), dtype=dt, device=dev)
    out = torch.zeros(npad * R, dtype=dt, device=dev)
    library_ms = cuda_ms(
        lambda: out.index_put_((flat,), ones, accumulate=True), 10)
    nnz = int(rl.sum())
    line = dict(name=name, route="cuda",
                source="slim_tpu_torch/csrc/densify.cu",
                replaces="slim_tpu/ops/pallas_gram.py:58",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                shape=f"densify_runs R={R} entries={nnz} longest="
                      f"{int(rl.max())} npad={npad} {str(dt)[6:]}",
                tol="exact")
    return with_bound(line, 4.0 * nnz + 12.0 * R + dt.itemsize * npad * R,
                      library_ms=library_ms)


def _sweep_inputs(dev, rng, n, nrows, nnz, B, large, nnbrs=0):
    """A real Gram (densify + contraction on the card) of a synth matrix,
    its first B columns' active sets (the screen, or with ``nnbrs`` their
    FSLIM neighbours, cos, as on the FSLIM path) and one sweep's operands.
    ``has`` is random (about 80% of the positions active), or with
    ``nnbrs`` the solver's own: the positions holding an active
    coordinate of a live column, active groups first for a group sweep."""
    from slim_tpu_torch.datagen import synth_implicit
    from slim_tpu_torch.ops.cd_kernel import (fslim_active_mask, per_col,
                                              screen)
    from slim_tpu_torch.ops.cd_sweep import CHUNK, GROUP
    from slim_tpu_torch.ops.gram import compute_gram
    from slim_tpu_torch.solvers.cd import bucket_npad

    mat = synth_implicit(nrows, n, nnz, seed=int(rng.integers(1 << 30)))
    npad = bucket_npad(n)
    G = compute_gram(mat, "device", pad_to=npad, device=dev)
    J = torch.arange(B, dtype=torch.int32, device=dev)
    J = torch.where(J < n, J, npad - 1)       # padded columns: zero column
    gj = G[:, J.long()].T.contiguous()
    l1 = per_col(1.0, B, dev)
    act = fslim_active_mask(gj, torch.diagonal(G), J, n, nnbrs, "cos") \
        if nnbrs else screen(gj, J, l1)
    width = GROUP if large else CHUNK
    npos = npad // width
    perm = torch.from_numpy(rng.permutation(npos).astype(np.int32)).to(dev)
    has = torch.from_numpy((rng.random(npos) < 0.8).astype(np.int32)).to(dev)
    live = torch.from_numpy((rng.random(B) < 0.9).astype(np.float32)).to(dev)
    if nnbrs:
        pos_any = (act.float() * live[:, None]).sum(dim=0) \
            .reshape(npos, width).sum(dim=1) > 0
        if large:
            perm = perm[torch.sort((~pos_any[perm.long()]).int(),
                                   stable=True).indices]
        has = pos_any[perm.long()].to(torch.int32)
    x = torch.where(act, torch.from_numpy(
        rng.random((B, npad)).astype(np.float32) * 0.01).to(dev), 0.0)
    q = x @ G
    regs = torch.stack([l1, per_col(1.0, B, dev),
                        torch.full((B,), 50.0, device=dev),
                        torch.zeros(B, device=dev),
                        torch.full((B,), 1e-7, device=dev)], dim=1)
    diag2d = torch.diagonal(G).reshape(1, npad).contiguous()
    return G, gj, act.to(torch.int8), x, q, live, diag2d, regs, perm, has


def _shape(B, npad, act, has):
    """A sweep check's shape: B, npad, active positions, and active
    coordinates per column."""
    return (f"B={B} npad={npad} active={int(has.sum())}/{has.numel()} "
            f"act_per_col={int(act.sum()) / B:.1f}")


def _cmp_sweep(got, ref):
    """(x max abs err, q max abs err relative to max |q|, live equal)."""
    ex = (got[0] - ref[0]).abs().max().item()
    eq = (got[1] - ref[1]).abs().max().item() / max(
        1.0, ref[1].abs().max().item())
    return ex, eq, torch.equal(got[2], ref[2])


def check_sweep(ops, note=""):
    """The whole-array sweep (random ``has``, about 80% of the chunks
    active; dead columns); ``note`` tags the shape."""
    from slim_tpu_torch.ops import cd_sweep as S

    args = _panel_args(ops, all_active=False)
    G, gj, has = args[0], args[1], args[-1]
    B = gj.shape[0]
    ref, plain_ms = once_ms(lambda: S.cd_sweep_plain(*args))
    ex, eq, same_live = _cmp_sweep(S.cd_sweep(*args), ref)
    check(ex <= 1e-4 and eq <= 1e-4 and same_live,
          f"sweep npad {G.shape[0]}: x err {ex}, q rel err {eq}, "
          f"live equal {same_live}")
    npad, na = G.shape[0], int(has.sum())
    line = dict(name=f"cd_sweep@{npad}", route="cuda",
                source="slim_tpu_torch/csrc/sweep_panel.cu",
                replaces="slim_tpu/ops/pallas_cd.py:58",
                max_abs_err=ex, q_rel_err=eq,
                ms=cuda_ms(lambda: S.cd_sweep(*args), 20), plain_ms=plain_ms,
                shape=_shape(B, npad, args[2], has) + note,
                tol="x 1e-4, q 1e-4 rel")
    # per active chunk: its G rows, the propagation and the GS triangle
    return with_bound(line, 4.0 * 128 * npad * na + B * npad * 21.0,
                      na * (2.0 * B * npad * 128 + B * 128 * 128.0))


def _large_args(ops, all_active):
    """cd_sweep_large's arguments (coordinate-major) from ``ops``: every
    group active, or ``ops``'s own ``has``."""
    G, gj, act, x, q, live, diag2d, regs, perm, has = ops
    if all_active:
        has = torch.ones_like(has)
    return (G, gj.T.contiguous(), act.T.contiguous(), x.T.contiguous(),
            q.T.contiguous(), live[None, :].contiguous(), diag2d,
            regs.T.contiguous(), perm, has)


def check_sweep_large(ops, all_active, note=""):
    """The coordinate-major sweep on transposed operands: every group
    active (phase 4's shape: at B 1024 every group of every sweep has
    work) or ``ops``'s own 38/56; ``note`` tags the shape."""
    from slim_tpu_torch.ops.cd_sweep import cd_sweep_large, cd_sweep_large_plain

    args = _large_args(ops, all_active)
    npad, B = args[1].shape
    has = args[-1]
    ref, plain_ms = once_ms(lambda: cd_sweep_large_plain(*args))
    ex, eq, same_live = _cmp_sweep(cd_sweep_large(*args), ref)
    check(ex <= 1e-4 and eq <= 1e-4 and same_live,
          f"large sweep: x err {ex}, q rel err {eq}, live equal {same_live}")
    line = dict(name="cd_sweep_large", route="cuda",
                source="slim_tpu_torch/csrc/sweep_large.cu",
                replaces="slim_tpu/ops/pallas_cd.py:920",
                max_abs_err=ex, q_rel_err=eq,
                ms=cuda_ms(lambda: cd_sweep_large(*args), 3),
                plain_ms=plain_ms,
                shape=_shape(B, npad, args[2], has) + note,
                tol="x 1e-4, q 1e-4 rel")
    return with_bound(line, *group_sweep_work(npad, B, has.tolist()))


def check_flush(ops):
    """The coordinate-major sweep's window flush alone at ``ops``'s shape
    (B 1024, npad 28672, every group active) on a random normal G and
    fresh deltas in all four slots (the time depends on the shape alone;
    on these values the float32 sums of the kernel and the plain version
    agree closely, where a Gram's count-sized entries would leave room for
    the summation order): one window on a q ~100 times its increment
    against flush_window_plain (within 1e-5 of the largest increment plus
    two float32 ulps of the largest q), then the sweep's 14 windows timed
    with CUDA events beside their bound, and the same windows with the TMA
    ring alone (``feed_only``).  Returns the two lines."""
    from slim_tpu_torch.ops import cd_sweep as S

    npad, B = ops[0].shape[0], ops[1].shape[0]
    dev = ops[0].device
    ng = npad // S.GROUP
    gen = torch.Generator(device=dev).manual_seed(1)
    gh, gl = S.split_bf16(torch.randn(npad, npad, device=dev, generator=gen))
    dh, dl = S.split_bf16(torch.randn(S.K_FLUSH * B * S.GROUP, device=dev,
                                      generator=gen) * 1e-2)
    perm = torch.arange(ng, dtype=torch.int32, device=dev)
    has = torch.ones(ng, dtype=torch.int32, device=dev)
    q = torch.randn(npad, B, device=dev, generator=gen) * 100.0
    ref, plain_ms = once_ms(lambda: S.flush_window_plain(
        gh, gl, dh, dl, perm, has, q.clone(), 0, S.K_FLUSH))
    got = S.flush_window(gh, gl, dh, dl, perm, has, q.clone(), 0, S.K_FLUSH)
    err = (got - ref).abs().max().item()
    tol = 1e-5 * (ref - q).abs().max().item() \
        + 2 * torch.finfo(torch.float32).eps * ref.abs().max().item()
    check(err <= tol, f"flush: q err {err} above {tol}")
    err /= ref.abs().max().item()
    windows = range(0, ng, S.K_FLUSH)

    def sweep(feed_only):
        for g0 in windows:
            S.flush_window(gh, gl, dh, dl, perm, has, q, g0,
                           min(S.K_FLUSH, ng - g0), feed_only)

    bn = S._flush_bn(npad, B)
    flops = 3 * 2.0 * npad * B * S.GROUP * ng
    # per window: G's halves of the window's columns once, q in and out
    nbytes = len(windows) * (4.0 * npad * S.GROUP * S.K_FLUSH
                             + 8.0 * npad * B)
    ms = cuda_ms(lambda: sweep(False), 10)
    bound_ms, by = bound(nbytes, flops, BF16_FLOPS)
    shape = f"B={B} npad={npad} active={ng}/{ng} windows={len(windows)}"
    line = dict(name="flush", source="slim_tpu_torch/csrc/sweep_large.cu",
                q_rel_err=err, tol="1e-5 of the increment + 2 ulp of q",
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, share=bound_ms / ms, tflops=flops / ms / 1e9,
                tile=f"128x{bn}", shape=shape, card=card_line())
    feed_ms = cuda_ms(lambda: sweep(True), 10)
    # each block stages per k-tile its 128 G rows and half the D tile's
    # rows (the other half comes multicast from its cluster peer), hi + lo
    tiles = npad // 128 * -(-B // bn)
    staged = len(windows) * tiles * S.K_FLUSH * (S.GROUP // 32) * 32 * 4 \
        * (128 + bn // 2)
    feed = dict(name="flush_feed", ms=feed_ms, l2_gbps=staged / feed_ms / 1e6,
                feeds_tflops=flops / feed_ms / 1e9,
                feeds_share=flops / feed_ms / 1e9 / (BF16_FLOPS / 1e12),
                tile=f"128x{bn}", shape=shape, card=card_line())
    return line, feed


def _panel_args(ops, all_active):
    """The row-major sweeps' arguments (cd_sweep, cd_sweep_v3,
    cd_sweep_eager) from ``ops``: every group active, or ``ops``'s own
    ``has``."""
    G, gj, act, x, q, live, diag2d, regs, perm, has = ops
    if all_active:
        has = torch.ones_like(has)
    return (G, gj, act, x, q, live[:, None].contiguous(), diag2d,
            regs.contiguous(), perm, has)


def mixed_regs(ops):
    """``ops`` as a packed grid block that straddles two points: the first
    half of the columns at l1r = l2r = 2 with a cap of 40 sweeps, the rest
    at 1 with 60, each column screened at its own l1r; t0 = 39, so the end
    of the sweep kills the first half at its cap and keeps the rest.  The
    visit order and ``has`` stay the operands' own."""
    from slim_tpu_torch.ops.cd_kernel import screen

    G, gj, act, x, q, live, diag2d, regs, perm, has = ops
    B = gj.shape[0]
    first = torch.arange(B, device=gj.device) < B // 2
    l12 = torch.where(first, 2.0, 1.0)
    act = screen(gj, torch.arange(B, dtype=torch.int32, device=gj.device),
                 l12)
    x = torch.where(act, x, 0.0)
    regs = torch.stack([l12, l12, torch.where(first, 40.0, 60.0),
                        torch.full_like(l12, 39.0), regs[:, 4]], dim=1)
    return (G, gj, act.to(torch.int8), x, x @ G, live, diag2d, regs, perm,
            has)


def profile_sweep(ops, row, out_dir, reps=3):
    """Device time by kernel of one sweep of each wide-block variant (v4,
    v3, eager) on ``ops`` and of the whole-array sweep on ``row``, all
    groups active and at the operands' own ``has``, under torch.profiler:
    calls and milliseconds per sweep of each device kernel, to
    ``out_dir/profile_sweep.json`` and to stdout."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from slim_tpu_torch.ops import cd_sweep as S

    out = []
    for variant, fn, make, src in (
            ("v4", S.cd_sweep_large, _large_args, ops),
            ("v3", S.cd_sweep_v3, _panel_args, ops),
            ("eager", S.cd_sweep_eager, _panel_args, ops),
            ("row", S.cd_sweep, _panel_args, row)):
        for all_active in (True, False):
            args = make(src, all_active)
            ms = cuda_ms(lambda: fn(*args), reps)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn(*args)
                torch.cuda.synchronize()
            rows = sorted((e for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA),
                          key=lambda e: -e.self_device_time_total)
            has = args[-1]
            out.append(dict(
                variant=variant, active=f"{int(has.sum())}/{has.numel()}",
                sweep_ms=ms,
                kernels=[dict(name=e.key[:90], calls=e.count / reps,
                              ms=e.self_device_time_total / 1e3 / reps)
                         for e in rows[:8]]))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_sweep.json"), "w") as f:
        json.dump(out, f, indent=1)
    print("profile sweep:", json.dumps(out), flush=True)


def check_sweep_panel(ops, variant, all_active):
    """The row-major deferred-flush sweep (v3: windows of K_FLUSH groups;
    eager: one group) against its plain version on the operands of
    check_sweep_large: every group active, or their random ``has``, which
    leaves inactive groups inside windows."""
    from slim_tpu_torch.ops import cd_sweep as S

    kern, plain, line = {
        "v3": (S.cd_sweep_v3, S.cd_sweep_v3_plain, 601),
        "eager": (S.cd_sweep_eager, S.cd_sweep_eager_plain, 313)}[variant]
    args = _panel_args(ops, all_active)
    G, gj, has = args[0], args[1], args[-1]
    B = gj.shape[0]
    ref, plain_ms = once_ms(lambda: plain(*args))
    ex, eq, same_live = _cmp_sweep(kern(*args), ref)
    check(ex <= 1e-4 and eq <= 1e-4 and same_live,
          f"{variant} sweep: x err {ex}, q rel err {eq}, "
          f"live equal {same_live}")
    npad = G.shape[0]
    out = dict(name=kern.__name__, route="cuda",
               source="slim_tpu_torch/csrc/sweep_panel.cu",
               replaces=f"slim_tpu/ops/pallas_cd.py:{line}",
               max_abs_err=ex, q_rel_err=eq,
               ms=cuda_ms(lambda: kern(*args), 3), plain_ms=plain_ms,
               shape=_shape(B, npad, args[2], has),
               tol="x 1e-4, q 1e-4 rel")
    return with_bound(out, *group_sweep_work(npad, B, has.tolist()))


def check_pack(dev, rng):
    from slim_tpu_torch.ops.pack import pack, pack_plain
    from slim_tpu_torch.utils import nnz_bucket

    B, K = 1024, 28672
    x = np.where(rng.random((B, K)) < 0.04,
                 rng.random((B, K)).astype(np.float32) + 0.5, 0.0)
    x[rng.random((B, K)) < 0.01] = 5e-8                     # below eps
    x = x.astype(np.float32)
    c = (x > np.float32(1e-7)).sum(axis=1)
    off = np.zeros(B, np.int32)
    np.cumsum(c[:-1], out=off[1:])
    Tpad = nnz_bucket(int(c.sum()), floor=128)
    xd, od = torch.from_numpy(x).to(dev), torch.from_numpy(off).to(dev)
    v1, i1 = pack(xd, od, 1e-7, Tpad)
    v0, i0 = pack_plain(xd, od, 1e-7, Tpad)
    same = torch.equal(v1, v0) and torch.equal(i1, i0)
    check(same, "pack differs from plain")

    # the library pair at the harvest's contiguous offsets: the values in
    # row-major order and their column ids
    def library():
        m = xd > 1e-7
        return torch.masked_select(xd, m), torch.nonzero(m)[:, 1]

    T = int(c.sum())
    lv, li = library()
    check(torch.equal(lv, v0[:T]) and torch.equal(li.to(torch.int32), i0[:T]),
          "masked_select + nonzero differ from the pack")
    line = dict(name="pack", route="cuda",
                source="slim_tpu_torch/csrc/pack.cu",
                replaces="slim_tpu/ops/pallas_pack.py:41", max_abs_err=0.0,
                ms=cuda_ms(lambda: pack(xd, od, 1e-7, Tpad), 20),
                plain_ms=cuda_ms(lambda: pack_plain(xd, od, 1e-7, Tpad), 3),
                shape=f"B={B} K={K}", tol="bit-equal")
    # x and the offsets read once, values and ids written once
    return with_bound(line, 4.0 * B * K + 4.0 * B + 8.0 * Tpad,
                      library_ms=cuda_ms(library, 20))


def check_gather(dev, rng, B=1024, chunk=8192,
                 shapes=((28672, 8192, ""), (94208, 61440, "@amzbook"))):
    """The compact block's gathers (``gather``, csrc/gather.cu) against
    ``gather_plain`` (two ``index_select``s), bit for bit, on a G that is
    not symmetric: G[S, S] and the targets' G[S, j] (B columns) at phase
    7's widest FSLIM union (npad 28672, K 8192) and at Amazon-Book's widest
    compact union (npad 94208, K 61440): ``shapes``, (npad, K, name
    suffix) each.  S is ascending, as the solver's
    unions are; the targets are B consecutive ranks.  The plain version is
    compared a ``chunk`` of rows at a time (at K 61440 its (K, npad)
    intermediate and its output would not fit beside G and the kernel's
    output) and timed whole with the kernel's output freed; where it does
    not fit even so, its time is None and ``plain_oom`` says why.  The
    bound: a read and a write of every output entry, 8 R C bytes."""
    from slim_tpu_torch.ops.gather import gather, gather_plain

    lines = []
    for npad, K, tag in shapes:
        torch.cuda.empty_cache()
        g = torch.Generator(device=dev).manual_seed(npad)
        G = torch.rand((npad, npad), generator=g, device=dev)
        S = torch.from_numpy(np.sort(rng.choice(npad - 1, K, replace=False))
                             .astype(np.int32)).to(dev)
        r0 = npad // 2
        J = torch.arange(r0, r0 + B, dtype=torch.int32, device=dev)
        for rows, trans, name, line in (
                (S, False, tag, 304),
                (J, True, (tag or "@fslim") + "_trans", 307)):
            R, C = rows.numel(), S.numel()
            got = gather(G, rows, S, trans)
            same = all(torch.equal(got[a:a + chunk],
                                   gather_plain(G, rows[a:a + chunk], S,
                                                trans))
                       for a in range(0, R, chunk))
            check(same, f"gather differs from plain at npad {npad}, R {R}, "
                        f"C {C}, trans {trans}")
            del got
            rec = dict(name="gather" + name, route="cuda",
                       source="slim_tpu_torch/csrc/gather.cu",
                       replaces=f"slim_tpu/ops/cd_kernel.py:{line}",
                       max_abs_err=0.0,
                       ms=cuda_ms(lambda: gather(G, rows, S, trans), 10),
                       shape=f"npad={npad} R={R} C={C} trans={int(trans)}",
                       tol="bit-equal")
            torch.cuda.empty_cache()
            try:
                rec["plain_ms"] = cuda_ms(
                    lambda: gather_plain(G, rows, S, trans), 3)
            except torch.cuda.OutOfMemoryError as e:
                rec["plain_ms"] = None
                rec["plain_oom"] = str(e).splitlines()[0]
            lines.append(with_bound(rec, 8.0 * R * C))
        del G
    torch.cuda.empty_cache()
    return lines


def run_synth(dev):
    from slim_tpu_torch import SlimConfig, determine_head_tail, evaluate_topn
    from slim_tpu_torch import get_topn, learn
    from slim_tpu_torch.io.readers import read_matrix

    data = os.path.join(HERE, "tests", "data")
    trn = read_matrix(os.path.join(data, "synth-train.ijv"), fmt="ijv") \
        .infer_ncols()
    tst = read_matrix(os.path.join(data, "synth-test.ijv"), fmt="ijv") \
        .infer_ncols()
    model, stats = learn(trn, SlimConfig(l1r=1.0, l2r=1.0), device=dev)
    _KEPT["synth"] = model
    ids, _, counts = get_topn(model, trn, nrcmds=10, sparse=False,
                              device=dev)
    n = max(trn.ncols, tst.ncols, model.ncols)
    res = evaluate_topn(ids, counts, tst, determine_head_tail(trn, n))
    out = dict(loss=stats["loss"], nnz=stats["nnz"], hr=res.hr,
               arhr=res.arhr, learn_s=stats["learn_s"])
    print("synth:", json.dumps(out))
    check(abs(stats["loss"] - SYNTH_LOSS) <= 1e-4 * SYNTH_LOSS,
          f"synth loss {stats['loss']}")
    check(abs(stats["nnz"] - SYNTH_NNZ) <= 0.01 * SYNTH_NNZ,
          f"synth nnz {stats['nnz']}")
    check(abs(res.hr - SYNTH_HR) < 0.015, f"synth hr {res.hr}")
    check(abs(res.arhr - SYNTH_ARHR) < 0.010, f"synth arhr {res.arhr}")
    return out


def _head_rows(mat, n):
    """The first ``n`` rows of a CSR (all, when it has fewer), same
    columns."""
    from slim_tpu_torch.types import CSR

    n = min(n, mat.nrows)
    end = int(mat.indptr[n])
    return CSR.from_arrays(n, mat.ncols, mat.indptr[:n + 1].copy(),
                           mat.indices[:end],
                           None if mat.data is None else mat.data[:end])


def _pick_rows(mat, users):
    """The rows ``users`` of a CSR, same columns."""
    from slim_tpu_torch.types import CSR

    sub = mat.to_scipy()[np.asarray(users)]
    return CSR.from_arrays(len(users), mat.ncols, sub.indptr.astype(np.int64),
                           sub.indices.astype(np.int32),
                           None if mat.data is None else sub.data)


def check_agree(tag, got, ref, rtol=1e-5, model=None, hist=None):
    """Two ranked results (ids, scores, counts) of two routes: the same
    counts, scores within ``rtol``, ids equal but at the near ties
    ``checks.ranked_mismatches`` forgives.  With the top-N's ``model`` and
    ``hist``, a user whose ids that rule does not forgive is held to the
    scipy oracle (``checks.topn_oracle_mismatches``) on both lists: where
    both are the oracle's top-N, the two routes split a near tie the
    lists alone cannot show (two items within ``rtol`` at the list's end,
    each route's last score printing the same float).  The users with an
    id left unforgiven are printed before the check fails."""
    from slim_tpu_torch.checks import ranked_mismatches, topn_oracle_mismatches

    check(np.array_equal(got[2], ref[2]), f"{tag}: counts differ")
    check(np.allclose(got[1], ref[1], rtol=rtol, atol=1e-6),
          f"{tag}: scores differ")
    differ, off_near = ranked_mismatches(*got[:2], *ref, rtol=rtol)
    off = {}                  # user -> its ids the rule does not forgive
    for u in np.nonzero((got[0] != ref[0]).any(axis=1))[0]:
        n = ranked_mismatches(*(a[u:u + 1] for a in got[:2]),
                              *(a[u:u + 1] for a in ref), rtol=rtol)[1]
        if n:
            off[u] = n
    oracle_near = []
    if off and model is not None:
        oracle_near = [u for u in off if not any(
            topn_oracle_mismatches(model, _pick_rows(hist, [u]),
                                   tuple(a[u:u + 1] for a in lists),
                                   rtol=rtol) for lists in (got, ref))]
        off_near -= sum(off[u] for u in oracle_near)
    for u in [u for u in off if u not in oracle_near][:4]:
        print(f"{tag}: user {u} ids {got[0][u].tolist()} vs "
              f"{ref[0][u].tolist()}, scores {got[1][u].tolist()} vs "
              f"{ref[1][u].tolist()}", flush=True)
    check(off_near == 0, f"{tag}: {off_near} ids differ off near ties")
    return dict(ids_differ=differ, ids_differ_off_near_ties=off_near,
                near_ties_by_oracle=len(oracle_near))


def run_ml1m(dev):
    """Phase 3b: a learn at MovieLens-1M's shape, every block on the
    whole-array sweep (npad 4096), then top-10 for every user."""
    from slim_tpu_torch import SlimConfig, learn
    from slim_tpu_torch.checks import ranked_mismatches
    from slim_tpu_torch.datagen import synth_implicit
    from slim_tpu_torch.ops import cd_sweep as S
    from slim_tpu_torch.predict import predict_topn

    trn = synth_implicit(*ML1M_SHAPE, seed=0)
    sweeps0 = S.cd_sweep.launches
    model, stats = learn(trn, SlimConfig(l1r=1.0, l2r=1.0, dbglvl=2,
                                         **ML1M_CFG), device=dev)
    calls = S.cd_sweep.launches - sweeps0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, sc, counts = predict_topn(model, trn, nrcmds=10, sparse=False,
                                   device=dev)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    _KEPT["ml1m"] = model
    # the first 256 users against the CPU path: the same counts, scores
    # within 1e-5 rel, and the same ids except at the near ties that
    # checks.ranked_mismatches forgives (f32 sums in another order may swap
    # such a pair); exact ties must come in the same (lowest-id) order
    ids_c, sc_c, cnt_c = predict_topn(model, _head_rows(trn, 256),
                                      nrcmds=10, sparse=False, device="cpu")
    differ, off_near = ranked_mismatches(ids[:256], sc[:256], ids_c, sc_c,
                                         cnt_c)
    solve_s = stats["phases"]["solve"]
    out = dict(nrows=trn.nrows, ncols=trn.ncols, nnz=trn.nnz,
               learn_s=stats["learn_s"], phases=stats["phases"],
               sweeps=stats["sweeps"], sweep_calls=calls,
               solve_ms_per_sweep=1e3 * solve_s / max(calls, 1),
               niters=stats["niters"], objective=stats["loss"],
               model_nnz=stats["nnz"], predict_s=pred_s,
               predict_users_per_s=trn.nrows / pred_s,
               ids_differ=differ, ids_differ_off_near_ties=off_near)
    print("ml1m:", json.dumps(out))
    check(ids.shape == (trn.nrows, 10) and np.all(ids < trn.ncols),
          "ml1m predict output malformed")
    check(np.array_equal(counts[:256], cnt_c)
          and np.allclose(sc[:256], sc_c, rtol=1e-5, atol=1e-6),
          "ml1m predict counts / scores differ from the CPU path")
    check(out["ids_differ_off_near_ties"] == 0,
          f"ml1m predict ids differ from the CPU path: {out}")
    check(abs(stats["loss"] - ML1M_OBJ) <= 1e-4 * ML1M_OBJ,
          f"ML-1M objective {stats['loss']}")
    check(abs(stats["nnz"] - ML1M_NNZ) <= 0.01 * ML1M_NNZ,
          f"ML-1M model nnz {stats['nnz']}")
    return out


@contextlib.contextmanager
def recording(module, name):
    """Each call of ``module.name`` while the block runs, as (args,
    kwargs, result), the function itself unchanged; restored after."""
    fn = getattr(module, name)
    calls = []

    def record(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def captured_stdout():
    """What the block prints, in a StringIO.  The CLIs point the root
    logger at the stream they print to, so its handlers and level are
    restored after."""
    import io
    import logging

    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            yield buf
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)


def cli_files(tmp, shape, seed=0):
    """Phase "cli"'s input files in ``tmp``: the ML-1M-shaped training
    matrix as a csr file with a repeated event in every 10th user (a copy
    of one of its items at a random position of its row, so the row is
    unsorted and has a duplicate), the same matrix without the repeats,
    and a held-out draw as the test file.  Returns the paths and the
    oracles: scipy's sum over the same triplets (independent of the
    port's reader), and the test matrix."""
    import scipy.sparse as sp

    from slim_tpu_torch.datagen import synth_implicit
    from slim_tpu_torch.io.readers import write_csr
    from slim_tpu_torch.types import CSR

    trn = synth_implicit(*shape, seed=seed)
    tst = synth_implicit(shape[0], shape[1], shape[0], seed=1)
    rng = np.random.default_rng(seed)
    rows = np.split(trn.indices, trn.indptr[1:-1])
    for u in range(0, trn.nrows, 10):
        r = rows[u]
        if len(r):
            rows[u] = np.insert(r, rng.integers(len(r) + 1),
                                r[rng.integers(len(r))])
    lens = np.array([len(r) for r in rows], np.int64)
    indptr = np.concatenate([[0], np.cumsum(lens)])
    indices = np.concatenate(rows).astype(np.int32)
    ones = np.ones(len(indices), np.float32)
    paths = {k: os.path.join(tmp, f"{k}.csr")
             for k in ("repeats", "canonical", "test")}
    write_csr(CSR.from_arrays(trn.nrows, trn.ncols, indptr, indices, ones),
              paths["repeats"])
    write_csr(CSR.from_arrays(trn.nrows, trn.ncols, trn.indptr, trn.indices,
                              np.ones(trn.nnz, np.float32)),
              paths["canonical"])
    tst = CSR.from_arrays(tst.nrows, int(tst.indices.max()) + 1, tst.indptr,
                          tst.indices, np.ones(tst.nnz, np.float32))
    write_csr(tst, paths["test"])
    users = np.repeat(np.arange(trn.nrows), lens)
    oracle = sp.coo_matrix((ones, (users, indices)),
                           shape=(trn.nrows, int(indices.max()) + 1)).tocsr()
    oracle.sum_duplicates()
    return paths, CSR.from_scipy(oracle), tst, int(len(indices) - trn.nnz)


def run_cli(dev):
    """Phase "cli": the three programs, in this process through their
    ``main(argv)`` with no ``-device`` (the default route, the card), on
    csr files at MovieLens-1M's shape whose every 10th user repeats an
    event.  Only the programs run here, so the path's launch counts are
    theirs; ``check_cli`` holds them to the API after the counts are
    read (the module docstring)."""
    import tempfile

    from slim_tpu_torch import predict as P
    from slim_tpu_torch.cli import slim_learn, slim_mselect, slim_predict
    from slim_tpu_torch.io.readers import read_matrix

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="slim_cli_") as tmp:
        paths, trn, tst, repeats = cli_files(tmp, ML1M_SHAPE)
        # the reader alone: the file with repeats is scipy's oracle
        t_read = {}
        for k in ("canonical", "repeats"):
            read, t_read[k] = _timed(lambda: read_matrix(paths[k], fmt="csr"))
        check(read == trn and read.shape == trn.shape,
              "cli: the csr reader's matrix is not scipy's sum of the "
              "file's triplets")
        mdl = os.path.join(tmp, "cli.model")
        out_f = os.path.join(tmp, "cli.topn")
        l12 = os.path.join(tmp, "l12")
        with open(l12, "w") as fh:
            fh.writelines(f"{a} {b}\n" for a, b in MSELECT_POINTS)
        c0 = _launch_counts()
        os.chdir(tmp)              # slim_mselect writes its models here
        try:
            with captured_stdout() as text, \
                    recording(slim_learn, "learn") as learns, \
                    recording(slim_predict, "predict_topn") as preds, \
                    recording(slim_mselect, "mselect_pairs") as sels:
                learn_s = _timed(lambda: check(slim_learn.main([
                    "-l1r=1.0", "-l2r=1.0",
                    f"-optTol={ML1M_CFG['optTol']}",
                    f"-niters={ML1M_CFG['maxniters']}",
                    f"-blocksize={ML1M_CFG['block_size']}",
                    paths["repeats"], mdl]) == 0, "slim_learn failed"))[1]
                predict_s = _timed(lambda: check(slim_predict.main([
                    f"-outfile={out_f}", mdl, paths["repeats"],
                    paths["test"]]) == 0, "slim_predict failed"))[1]
                route = P.last_route
                mselect_s = _timed(lambda: check(slim_mselect.main([
                    paths["repeats"], paths["test"], l12]) == 0,
                    "slim_mselect failed"))[1]
        finally:
            os.chdir(cwd)
        printed = text.getvalue()
        cli_launches = {k: v for k, v in _since(c0).items() if v}
        with open(out_f) as fh:
            listed = [line.split()[0::2] for line in fh]
    print(printed, end="", flush=True)
    check(len(learns) == len(preds) == len(sels) == 1,
          f"cli: {len(learns)} learns, {len(preds)} predicts, {len(sels)} "
          "model selections recorded")
    return dict(trn=trn, tst=tst, repeats=repeats, t_read=t_read,
                learn_s=learn_s, predict_s=predict_s, mselect_s=mselect_s,
                printed=printed, listed=listed, route=route, learn=learns[0],
                predict=preds[0], mselect=sels[0], cli_launches=cli_launches)


def check_cli(dev, run):
    """Phase "cli"'s gates, on what ``run_cli`` recorded: each program
    held to the API on scipy's oracle of the same triplets, and its
    printed lines to what it computed.  Prints the ``cli:`` line."""
    from slim_tpu_torch import SlimConfig, learn
    from slim_tpu_torch import determine_head_tail, evaluate_topn
    from slim_tpu_torch import predict as P
    from slim_tpu_torch.mselect import mselect_pairs

    trn, tst, printed, route = (run["trn"], run["tst"], run["printed"],
                                run["route"])

    # slim_learn against api.learn on the oracle: same data and seed
    _, stats = run["learn"][2]
    model, ref = learn(trn, SlimConfig(l1r=1.0, l2r=1.0, **ML1M_CFG),
                       device=dev)
    check(f"model nnz: {stats['nnz']}  loss: {stats['loss']:.5e}"
          in printed, "slim_learn printed another result than it learned")
    check(abs(stats["loss"] - ref["loss"]) <= 1e-6 * abs(ref["loss"])
          and stats["nnz"] == ref["nnz"],
          f"cli learn {stats['loss']} / {stats['nnz']} vs api.learn "
          f"{ref['loss']} / {ref['nnz']}")

    # slim_predict's lists (the model from its file) against the API's
    (cli_model, *_), _, (ids, sc, counts) = run["predict"]
    check(run["listed"] == [[str(i) for i in row[:c]] for row, c in zip(ids, counts)],
          "slim_predict's outfile holds other lists than it scored")
    api = P.predict_topn(model, trn, nrcmds=10, device=dev)
    check(P.last_route == route, f"cli predict on {route}, the API's on "
          f"{P.last_route}")
    agree = check_agree("cli predict", (ids, sc, counts), api, model=model,
                        hist=trn)
    fmarker = determine_head_tail(trn, max(trn.ncols, tst.ncols,
                                           cli_model.ncols))
    ev = evaluate_topn(ids, counts, tst, fmarker)
    ev_api = evaluate_topn(api[0], api[2], tst, fmarker)
    check(f"hr: {ev.hr:.4f} hr_head: {ev.hr_head:.4f} "
          f"hr_tail: {ev.hr_tail:.4f} arhr: {ev.arhr:.4f}" in printed,
          "slim_predict printed another HR / ARHR than its lists give")
    # a near tie swapped at the list's end moves at most one hit a user
    slack = ((ids != api[0]).any(axis=1).sum()) / max(ev.nvalid, 1)
    check(abs(ev.hr - ev_api.hr) <= slack
          and abs(ev.arhr - ev_api.arhr) <= slack,
          f"cli HR / ARHR {ev.hr} / {ev.arhr} vs the API's {ev_api.hr} / "
          f"{ev_api.arhr}")

    # slim_mselect against mselect_pairs on the oracles
    got = run["mselect"][2]
    want = mselect_pairs(trn, tst, SlimConfig(optTol=ML1M_CFG["optTol"],
                                              maxniters=ML1M_CFG["maxniters"]),
                         MSELECT_POINTS, device=dev)
    best = (got["bestl1HR"], got["bestl2HR"])
    best_hr = max(r["hr"] for r in got["results"])
    check(best == (want["bestl1HR"], want["bestl2HR"])
          and abs(best_hr - max(r["hr"] for r in want["results"])) <= 1e-6,
          f"cli mselect best {best} (HR {best_hr}) vs the API's "
          f"{(want['bestl1HR'], want['bestl2HR'])}")
    check(f"The selected hyperparameters are l1r: {best[0]:.2f} "
          f"l2r: {best[1]:.2f}" in printed,
          "slim_mselect printed another best point than it chose")
    out = dict(nrows=trn.nrows, ncols=trn.ncols, nnz=trn.nnz,
               repeated_events=run["repeats"], read_s=run["t_read"]["repeats"],
               read_canonical_s=run["t_read"]["canonical"],
               learn_s=run["learn_s"], predict_s=run["predict_s"],
               mselect_s=run["mselect_s"], objective=stats["loss"],
               objective_api=ref["loss"], model_nnz=stats["nnz"],
               predict_route=route, hr=ev.hr, arhr=ev.arhr, hr_api=ev_api.hr,
               arhr_api=ev_api.arhr, mselect_best=best,
               mselect_best_hr=best_hr, cli_launches=run["cli_launches"],
               **agree, card=card_line())
    print("cli:", json.dumps(out))
    return out


def launch_wrappers():
    """The kernel wrappers whose ``launches`` counters the driven paths
    are held to, by kernel name."""
    from slim_tpu_torch.ops import kernel_wrappers

    return kernel_wrappers()


def _launch_counts():
    """A snapshot of every kernel's launch counter."""
    return {k: w.launches for k, w in launch_wrappers().items()}


def _since(counts0):
    """The launches made since the snapshot ``counts0``, by kernel."""
    return {k: w.launches - counts0[k] for k, w in launch_wrappers().items()}


def _learn_record(stats, counts0):
    """The printed record of one learn, with the launches it added to
    ``counts0`` (a snapshot of the counters)."""
    counts = _since(counts0)
    return dict(learn_s=stats["learn_s"], phases=stats["phases"],
                sweeps=stats["sweeps"], niters=stats["niters"],
                union_widths=stats.get("union_widths"),
                objective=stats["loss"], model_nnz=stats["nnz"],
                launches={k: v for k, v in counts.items() if v})


def _fslim_learn(dev, trn, cfg):
    from slim_tpu_torch import learn

    counts0 = _launch_counts()
    model, stats = learn(trn, cfg, device=dev)
    col_nnz = np.diff(model.transpose().indptr)
    check(col_nnz.max() <= cfg.nnbrs,
          f"FSLIM column with {col_nnz.max()} nonzeros > {cfg.nnbrs}")
    return model, stats, _learn_record(stats, counts0)


def _check_same_fit(tag, stats, obj, nnz):
    check(abs(stats["loss"] - obj) <= 1e-4 * obj,
          f"{tag} objective {stats['loss']} vs {obj}")
    check(abs(stats["nnz"] - nnz) <= 0.01 * nnz,
          f"{tag} model nnz {stats['nnz']} vs {nnz}")


def run_ml1m_fslim(dev):
    """Phase 3c: FSLIM (nnbrs 50, cos) at MovieLens-1M's shape, full width
    (npad 4096, the whole-array sweep) and with compact_threshold 2048
    (every block on its FSLIM union), both against the JAX package's
    result on JAX-CPU; every column on at most 50 coordinates."""
    from slim_tpu_torch import SlimConfig
    from slim_tpu_torch.datagen import synth_implicit

    trn = synth_implicit(*ML1M_SHAPE, seed=0)
    out = {}
    for tag, extra in (("full", {}), ("compact", dict(compact_threshold=2048))):
        cfg = SlimConfig(dbglvl=2, **FSLIM_CFG, **ML1M_CFG, **extra)
        _, stats, out[tag] = _fslim_learn(dev, trn, cfg)
        _check_same_fit(f"ML-1M FSLIM {tag}", stats, ML1M_FSLIM_OBJ,
                        ML1M_FSLIM_NNZ)
    print("ml1m_fslim:", json.dumps(out))
    check(out["compact"]["union_widths"] and max(
        out["compact"]["union_widths"]) < 4096,
        "ML-1M FSLIM compact learn solved no compact block")
    return out


def check_unions(dev, trn, model, stats, ntargets=256):
    """Union exactness of an FSLIM learn on the compact path: for targets
    spread over the blocks, the full-width top-nnbrs set (the plain
    ``fslim_active_mask`` over the rank-space Gram, on the card) lies in
    the block's union, and the model column's support lies in that set."""
    from slim_tpu_torch.ops.cd_kernel import fslim_active_mask
    from slim_tpu_torch.ops.gram import compute_gram
    from slim_tpu_torch.solvers.cd import COMPACT_BMAX, bucket_npad

    n = trn.ncols
    npad = bucket_npad(n)
    B = min(ML20M_CFG["block_size"], COMPACT_BMAX)
    p = np.argsort(-trn.col_nnz(), kind="stable")     # the solver's ranks
    p_d = torch.from_numpy(np.concatenate([p, np.arange(n, npad)])).to(dev)
    G = compute_gram(trn, "device", pad_to=npad, device=dev)
    G = G.index_select(0, p_d).index_select(1, p_d)
    ranks = np.linspace(0, n - 1, ntargets).round().astype(np.int64)
    J = torch.from_numpy(ranks.astype(np.int32)).to(dev)
    mask = fslim_active_mask(G[:, J.long()].T.contiguous(), torch.diagonal(G),
                             J, n, FSLIM_CFG["nnbrs"], FSLIM_CFG["simtype"])
    mask = mask.cpu().numpy()
    del G
    posmap = np.empty(n, np.int64)
    posmap[p] = np.arange(n)
    csc = model.transpose()
    out = dict(targets=ntargets, in_compact_blocks=0, outside_union=0,
               support_outside_top=0)
    for t, r in enumerate(ranks):
        top = np.nonzero(mask[t])[0]
        S = stats["unions"].get(int(r) // B)
        if S is not None:
            out["in_compact_blocks"] += 1
            out["outside_union"] += int(np.setdiff1d(top, S).size)
        j = p[r]
        sup = posmap[csc.indices[csc.indptr[j]:csc.indptr[j + 1]]]
        out["support_outside_top"] += int(np.setdiff1d(sup, top).size)
    check(out["outside_union"] == 0 and out["support_outside_top"] == 0,
          f"FSLIM unions not exact: {out}")
    return out


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _candidates(tst, nusers, ncols, nnegs=100):
    """(nusers, C) candidates: each user's held-out items, -1 padded, then
    ``nnegs`` negatives drawn with default_rng(3)."""
    rows = tst.indptr[:nusers + 1]
    cnt = np.diff(rows)
    held = np.full((nusers, max(int(cnt.max()), 1)), -1, np.int32)
    r = np.repeat(np.arange(nusers), cnt)
    held[r, np.arange(rows[-1]) - rows[:-1][r]] = tst.indices[:rows[-1]]
    neg = np.random.default_rng(3).integers(0, ncols, (nusers, nnegs))
    return np.concatenate([held, neg.astype(np.int32)], axis=1)


def run_fslim(dev, trn, nhead=4096, ntime=16384):
    """Phase 7: FSLIM at full ML-20M scale on the compact path, its union
    exactness, the same learn with every union snapped to full width
    (SLIM_COMPACT_FRAC=0, every block on v4 at npad 28672), then the model
    served: dense top-N for every user; the dense, score-row and COO top-N
    timed on the first ``ntime`` users with the model on the card; for
    the first ``nhead`` users the sparse and COO top-N, 1-vs-k and
    candidate scores on every route, held to the dense route."""
    from slim_tpu_torch import SlimConfig
    from slim_tpu_torch.datagen import synth_implicit
    from slim_tpu_torch.predict import (densify_model,
                                        predict_candidate_scores,
                                        predict_topn, predict_topn_1vsk)
    from slim_tpu_torch.solvers.cd import bucket_npad

    cfg = SlimConfig(dbglvl=2, **FSLIM_CFG, **ML20M_CFG)
    model, stats, out = _fslim_learn(dev, trn, cfg)
    out["unions"] = check_unions(dev, trn, model, stats)
    with env(SLIM_COMPACT_FRAC="0"):
        _, st_full, out["full_width"] = _fslim_learn(dev, trn, cfg)
    check(set(st_full["union_widths"]) == {bucket_npad(trn.ncols)},
          f"SLIM_COMPACT_FRAC=0 left unions {st_full['union_widths']}")
    _check_same_fit("ML-20M FSLIM full width", st_full, stats["loss"],
                    stats["nnz"])
    print("fslim learn:", json.dumps(out))

    serve = {}
    _KEPT["fslim"] = model
    dense, t = _timed(lambda: predict_topn(model, trn, nrcmds=10,
                                           sparse=False, device=dev))
    serve["dense_all"] = dict(users=trn.nrows, s=t, users_per_s=trn.nrows / t)
    W, serve["dense_model_s"] = _timed(lambda: densify_model(model,
                                                             device=dev))
    serve["same_users"] = route_times(model, _head_rows(trn, ntime), W, dev)
    head = _head_rows(trn, nhead)
    ref = tuple(a[:nhead] for a in dense)
    routes = {"dense": dict(sparse=False, W_dev=W),
              "sparse": dict(sparse=True), "coo": dict(sparse=True)}
    cand = _candidates(synth_implicit(trn.nrows, trn.ncols, trn.nrows,
                                      seed=1), nhead, trn.ncols)
    first = {}
    for route, kw in routes.items():
        with env(SLIM_PREDICT_COO_NPAD="1" if route == "coo" else "0"):
            rec = {}
            if route != "dense":
                got, t = _timed(lambda: predict_topn(model, head, nrcmds=10,
                                                     device=dev, **kw))
                rec["topn"] = dict(s=t, users_per_s=nhead / t,
                                   **check_agree(f"{route} top-N", got, ref,
                                                 model=model, hist=head))
            one, t = _timed(lambda: predict_topn_1vsk(
                model, head, cand, nrcmds=10, device=dev, **kw))
            rec["1vsk"] = dict(s=t, users_per_s=nhead / t)
            cs, t = _timed(lambda: predict_candidate_scores(
                model, head, cand, device=dev, **kw))
            rec["cand"] = dict(s=t, users_per_s=nhead / t)
        if route == "dense":
            first = dict(one=one, cs=cs)
        else:
            rec["1vsk"].update(check_agree(f"{route} 1-vs-k", one,
                                           first["one"]))
            check(np.array_equal(cs[1], first["cs"][1])
                  and np.allclose(cs[0], first["cs"][0], rtol=1e-5,
                                  atol=1e-6),
                  f"{route} candidate scores differ from dense")
        serve[route] = rec
    del W
    check(dense[0].shape == (trn.nrows, 10) and np.all(dense[0] < trn.ncols),
          "FSLIM predict output malformed")
    print("fslim serve:", json.dumps(serve))
    return dict(out, serve=serve)


def route_times(model, users, W, dev, rounds=2):
    """Seconds and users/s of top-10 for ``users`` on the dense route (the
    resident ``W``) and on the two sparse routes, ``rounds`` rounds in
    turns.  The first round uploads the histories and the sparse routes'
    model rows, so no route uploads anything in a later round."""
    from slim_tpu_torch.predict import predict_topn

    secs = {"dense": [], "rows": [], "coo": []}
    for _ in range(rounds):
        for route, ts in secs.items():
            kw = dict(W_dev=W, sparse=False) if route == "dense" \
                else dict(sparse=True)
            with env(SLIM_PREDICT_COO_NPAD="1" if route == "coo" else "0"):
                _, t = _timed(lambda: predict_topn(model, users, nrcmds=10,
                                                   device=dev, **kw))
            ts.append(t)
    return dict(users=users.nrows, **{
        r: dict(s=ts, users_per_s=[users.nrows / t for t in ts])
        for r, ts in secs.items()})


def serve_workload():
    """scripts/predict_large_bench.py's serving workload (SERVE_SHAPE),
    built here with the port's CSR: (model, histories)."""
    from slim_tpu_torch.types import CSR

    n, nusers = SERVE_SHAPE["n"], SERVE_SHAPE["nusers"]
    rng = np.random.default_rng(SERVE_SHAPE["seed"])
    mr = np.repeat(np.arange(n), SERVE_SHAPE["nnz_row"])
    mc = (rng.zipf(1.3, mr.size * 2) % n)[:mr.size]
    mv = rng.random(mr.size, dtype=np.float32) + 0.01
    model = CSR.from_ijv(mr, mc, mv, nrows=n, ncols=n)
    hr = np.repeat(np.arange(nusers), SERVE_SHAPE["hlen"])
    hc = (rng.zipf(1.2, hr.size * 2) % n)[:hr.size]
    hist = CSR.from_ijv(hr, hc, np.ones(hr.size, np.float32),
                        nrows=nusers, ncols=n).binarize()
    return model, hist


def run_serve(dev, noracle=1024):
    """Phase 8: the padded-sparse route where it is the only route: top-10
    for all 100,000 users of the 262,144-item serving workload by score
    rows (the default there) and by COO, each twice in turns (the first
    call also uploads the model and histories); the two agree (ids equal
    but at near ties) and the first ``noracle`` users match a scipy
    oracle."""
    from slim_tpu_torch.checks import topn_oracle_mismatches
    from slim_tpu_torch.predict import predict_topn

    (model, hist), gen_s = _timed(serve_workload)
    secs = {"rows": [], "coo": []}
    for route in ("rows", "coo", "rows", "coo"):     # in turns
        with env(SLIM_PREDICT_COO_NPAD="1" if route == "coo" else "0"):
            res, t = _timed(lambda: predict_topn(model, hist, nrcmds=10,
                                                 sparse=True, device=dev))
        secs[route].append(t)
        if route == "rows":
            rows = res
        else:
            agree = check_agree("serve COO vs score rows", res, rows,
                                model=model, hist=hist)
    bad = topn_oracle_mismatches(model, _head_rows(hist, noracle),
                                 tuple(a[:noracle] for a in rows))
    out = dict(nitems=model.ncols, nusers=hist.nrows, model_nnz=model.nnz,
               hist_nnz=hist.nnz, datagen_s=gen_s,
               **{r: dict(s=ts, users_per_s=[hist.nrows / t for t in ts])
                  for r, ts in secs.items()},
               oracle_users=noracle, oracle_mismatch=bad, **agree)
    print("serve:", json.dumps(out))
    check(bad == 0, f"{bad} users differ from the scipy oracle")
    check(rows[0].shape == (hist.nrows, 10) and np.all(rows[0] < model.ncols)
          and np.all(rows[2] >= 0), "serve output malformed")
    return out


def device_busy_s(prof):
    """Seconds in which the card ran anything (kernels, copies, memsets) in
    a profiled run: the union of their intervals, so that work on any
    stream counts once."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def write_profile(prof, wall_s, out_dir):
    """Device time of a profiled run by kernel: the full operator table to
    ``profile_ml20m.txt``; the device rows (kernels, copies, memsets), the
    sum of their times, the busy time (:func:`device_busy_s`: overlapping
    rows of two streams counted once) and the idle share of ``wall_s`` to
    ``profile_ml20m.json`` and to stdout."""
    from torch.autograd import DeviceType

    ka = prof.key_averages()
    rows = sorted((e for e in ka if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_s = device_busy_s(prof)
    summary = dict(wall_s=wall_s, device_busy_s=busy_s,
                   device_sum_s=sum(e.self_device_time_total
                                    for e in rows) / 1e6,
                   idle_share=1.0 - busy_s / wall_s,
                   top=[dict(name=e.key, calls=e.count,
                             device_s=e.self_device_time_total / 1e6)
                        for e in rows[:10]])
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_ml20m.txt"), "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    with open(os.path.join(out_dir, "profile_ml20m.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print("profile:", json.dumps(summary), flush=True)


def run_ml20m(dev, trn, profile_dir=None):
    if profile_dir is not None:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = _learn_predict_ml20m(dev, trn)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        write_profile(prof, wall_s, profile_dir)
        return out
    return _learn_predict_ml20m(dev, trn)


def _learn_predict_ml20m(dev, trn):
    from slim_tpu_torch import SlimConfig, learn
    from slim_tpu_torch import predict as P
    from slim_tpu_torch.predict import predict_topn

    cfg = SlimConfig(l1r=1.0, l2r=1.0, dbglvl=2, **ML20M_CFG)
    model, stats = learn(trn, cfg, device=dev)
    _KEPT["ml20m"] = model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # unpinned: the router keeps this model on the card (its per-user work
    # is far above the native route's threshold), at "high" by the npad rule
    ids, _, counts = predict_topn(model, trn, nrcmds=10, device=dev)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    out = dict(nrows=trn.nrows, ncols=trn.ncols, nnz=trn.nnz,
               learn_s=stats["learn_s"], phases=stats["phases"],
               assembly=stats["assembly"],
               sweeps=stats["sweeps"], niters=stats["niters"],
               objective=stats["loss"], fit=stats["fit"],
               model_nnz=stats["nnz"], predict_s=pred_s, predict_users_per_s=trn.nrows / pred_s,
               predict_route=P.last_route,
               predict_precision=P.last_precision,
               cols_per_s=trn.ncols / stats["learn_s"])
    print("ml20m:", json.dumps(out))
    check(P.last_route == "dense" and P.last_precision == "high",
          f"the ML-20M predict took the {P.last_route} route at "
          f"{P.last_precision}")
    check(ids.shape == (trn.nrows, 10) and np.all(counts >= 0)
          and np.all(ids < trn.ncols), "predict output malformed")
    check_gates("ML-20M", stats)
    out["precision"] = predict_precisions(model, trn, dev)
    out["model_densify"] = model_densify_times(model, dev)
    return out


def _harvest_record(stats):
    return dict(learn_s=stats["learn_s"], phases=stats["phases"],
                assembly=stats["assembly"],
                objective=stats["loss"], model_nnz=stats["nnz"],
                sweeps=stats["sweeps"], niters=stats["niters"])


def _same_learn(tag, got, ref):
    """Two learns of one matrix equal entry for entry, the objective and
    the other stats bit-equal."""
    (m, s), (r, t) = got, ref
    check(m.shape == r.shape and np.array_equal(m.indptr, r.indptr)
          and np.array_equal(m.indices, r.indices)
          and np.array_equal(m.data, r.data),
          f"{tag}: the models differ")
    for k in ("loss", "fit", "niters", "sweeps"):
        check(s[k] == t[k], f"{tag}: {k} {s[k]} vs {t[k]}")


@contextlib.contextmanager
def patched(module, **attrs):
    """``module``'s attributes set to ``attrs`` inside the block, restored
    after."""
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def check_harvest_ml20m(dev, trn, rec):
    """Phase 4's harvest check, run after its launch counts are read: the
    same learn again with its entries held on the card, its held blocks
    also assembled by ``native.csr_from_blocks`` (copied to the host),
    then with its entries moved to host memory at block 1 (the card's
    budget patched to block 0's bytes) and sorted there; phase 4's model,
    the native one and the moved learn's equal entry for entry, the
    objective bit-equal.  Prints learn_s, phases and ``assembly`` of each
    and the native assembly's entries and seconds."""
    from slim_tpu_torch import SlimConfig, learn, native
    from slim_tpu_torch.solvers import cd as C
    from slim_tpu_torch.types import CSR

    cfg = SlimConfig(l1r=1.0, l2r=1.0, dbglvl=2, **ML20M_CFG)
    first = (_KEPT["ml20m"], dict(loss=rec["objective"], fit=rec["fit"],
                                  niters=rec["niters"],
                                  sweeps=rec["sweeps"]))
    seen = {}
    real = C._assemble

    def both(coord, target, vals, n):
        seen["block0"] = len(vals[0])
        host = [[a.cpu().numpy() for a in lst]
                for lst in (coord, target, vals)]
        t0 = time.perf_counter()
        seen["native"] = CSR.from_arrays(
            n, n, *native.csr_from_blocks(*host, n))
        seen["native_s"] = time.perf_counter() - t0
        return real(coord, target, vals, n)

    with patched(C, _assemble=both):
        held = learn(trn, cfg, device=dev)
    budget = 12 * seen["block0"]
    with patched(C, _card_budget=lambda d: budget):
        moved = learn(trn, cfg, device=dev)
    nat = seen["native"]
    out = dict(first=dict(learn_s=rec["learn_s"], phases=rec["phases"],
                          assembly=rec["assembly"]),
               held=_harvest_record(held[1]),
               moved=_harvest_record(moved[1]),
               native=dict(entries=nat.nnz, s=seen["native_s"]),
               device=card_line())
    print("ml20m harvest:", json.dumps(out), flush=True)
    check(rec["assembly"] == held[1]["assembly"] == "card",
          f"the ML-20M learns assembled on the {rec['assembly']} and the "
          f"{held[1]['assembly']}")
    check(moved[1]["assembly"] == "host",
          f"the moved ML-20M learn assembled on the "
          f"{moved[1]['assembly']}")
    _same_learn("ML-20M held learn again", held, first)
    _same_learn("ML-20M native assembly", (nat, held[1]), first)
    _same_learn("ML-20M learn moved to host memory", moved, first)
    rec["harvest"] = out
    return rec


def model_densify_times(model, dev):
    """Phase 4's model densified as ``predict.densify_model`` does it (its
    27,278 rows as runs straight into W's rows: one row-major launch)
    against the transposed densify plus a transpose copy, in turns, each
    its least of 3; the two W must be equal."""
    from slim_tpu_torch.ops.densify import densify_runs
    from slim_tpu_torch.predict import densify_model
    from slim_tpu_torch.solvers.cd import bucket_npad

    npad = bucket_npad(max(model.nrows, model.ncols))
    rs = np.zeros(npad, np.int64)
    rl = np.zeros(npad, np.int64)
    rs[:model.nrows] = model.indptr[:-1]
    rl[:model.nrows] = model.row_nnz()
    idx = model.dev_put("idx32", lambda: model.indices.astype(np.int32), dev)
    val = model.dev_put("val32", lambda: model.values().astype(np.float32),
                        dev)

    def transposed():
        M = densify_runs(idx, val, rs, rl, npad, npad, torch.empty(
            (npad, npad), device=dev))
        return M.T.contiguous()

    (rm, tr), secs = _in_turns(
        [lambda: densify_model(model, npad, dev), transposed], under_s=60.0,
        rounds=3)
    same = bool(torch.equal(rm, tr))
    del rm, tr
    line = dict(runs=model.nrows, npad=npad, nnz=model.nnz,
                row_major_s=min(secs[0]), transposed_copy_s=min(secs[1]),
                runs_s=secs, equal=same)
    print("ml20m model densify:", json.dumps(line), flush=True)
    check(same, "densify_model differs from the transposed densify's .T")
    return line


PRECISION_ORACLE_USERS = 512


def predict_precisions(model, trn, dev):
    """Phase 4's users at each precision with the model on the card (two
    rounds in turns, each call its least), and the gates on "high" and
    "default" against "highest" (see the module docstring)."""
    from slim_tpu_torch.checks import ranked_mismatches, topn_oracle_mismatches
    from slim_tpu_torch.predict import densify_model, predict_topn

    W = densify_model(model, device=dev)
    precs = ("high", "highest", "default")
    res, secs = _in_turns([
        (lambda p=p: predict_topn(model, trn, nrcmds=10, W_dev=W,
                                  precision=p, device=dev))
        for p in precs], under_s=60.0, rounds=2)
    del W
    got = dict(zip(precs, res))
    ref = got["highest"]
    ok = ref[0] >= 0
    out = {}
    for p, s in zip(precs, secs):
        rel = np.abs(got[p][1][ok] - ref[1][ok]) / ref[1][ok]
        differ, off = ranked_mismatches(*got[p][:2], *ref, rtol=1e-5)
        out[p] = dict(s=min(s), runs_s=s, users_per_s=trn.nrows / min(s),
                      max_rel_err=float(rel.max()) if rel.size else 0.0,
                      ids_differ=differ, ids_differ_off_near_ties=off)
    head = _head_rows(trn, PRECISION_ORACLE_USERS)
    out["high"]["oracle_mismatches"] = topn_oracle_mismatches(
        model, head, tuple(a[:PRECISION_ORACLE_USERS] for a in got["high"]))
    print("ml20m precisions:", json.dumps(out), flush=True)
    check(out["high"]["max_rel_err"] < 2.0 ** -16,
          f"ML-20M high: scores {out['high']['max_rel_err']} rel from "
          "highest")
    out["high"]["agree"] = check_agree(
        "ML-20M high vs highest", got["high"], ref, model=model, hist=trn)
    check(out["high"]["oracle_mismatches"] == 0,
          f"ML-20M high: {out['high']['oracle_mismatches']} of the first "
          f"{PRECISION_ORACLE_USERS} users differ from the scipy oracle")
    check(out["default"]["max_rel_err"] < 2.0 ** -7,
          f"ML-20M default: scores {out['default']['max_rel_err']} rel "
          "from highest")
    return out


def run_mselect(dev, trn, cold_niters):
    """Phase 5: the warm-started model-selection walk on the v3 sweep."""
    from slim_tpu_torch import SlimConfig
    from slim_tpu_torch.datagen import synth_implicit
    from slim_tpu_torch.mselect import mselect_pairs
    from slim_tpu_torch.predict import densify_model

    tst = synth_implicit(trn.nrows, trn.ncols, trn.nrows, seed=1)
    pack_err = []

    def cb(rec, model):
        pack = rec["pack"]
        check(pack is not None, "mselect kept no device model")
        ref = densify_model(model, npad=pack.npad, device=dev)
        pack_err.append((pack.densify() - ref).abs().max().item())
        pack.free_dense()

    with env(SLIM_PALLAS_V4="0"):
        res = mselect_pairs(trn, tst, SlimConfig(**ML20M_CFG), MSELECT_POINTS,
                            point_callback=cb, device=dev)
    points = [dict(l1r=r["l1r"], l2r=r["l2r"], learn_s=r["time"],
                   sweeps=r["sweeps"], niters=r["niters"],
                   predict_s=r["time_predict"], hr=r["hr"], arhr=r["arhr"],
                   objective=r["loss"], model_nnz=r["nnz"], pack_err=e)
              for r, e in zip(res["results"], pack_err)]
    for pt in points:
        print("mselect point:", json.dumps(pt))
    warm = points[-1]
    check_gates("warm (1, 1)", dict(loss=warm["objective"],
                                    nnz=warm["model_nnz"]))
    check(warm["niters"] < cold_niters,
          f"warm (1, 1) took {warm['niters']} column-iterations, cold "
          f"{cold_niters}")
    check(len(pack_err) == len(MSELECT_POINTS)
          and max(pack_err) <= 1e-6, f"pack densify errors {pack_err}")
    return points


def run_eager(dev, trn):
    """Phase 6: one cold learn on the eager sweep."""
    from slim_tpu_torch import SlimConfig, learn

    with env(SLIM_PALLAS_V3="0", SLIM_PALLAS_V4="0"):
        _, stats = learn(trn, SlimConfig(l1r=1.0, l2r=1.0, **ML20M_CFG),
                         device=dev)
    out = dict(learn_s=stats["learn_s"], phases=stats["phases"],
               sweeps=stats["sweeps"], niters=stats["niters"],
               objective=stats["loss"], model_nnz=stats["nnz"])
    print("eager:", json.dumps(out))
    check_gates("eager", stats)
    return out


def admm_workload():
    """scripts/admm_bench.py's workload (ADMM_SHAPE), built here with the
    port's CSR."""
    from slim_tpu_torch.types import CSR

    nrows, ncols, draws = (ADMM_SHAPE[k] for k in ("nrows", "ncols",
                                                   "draws"))
    rng = np.random.default_rng(0)
    users = rng.integers(0, nrows, draws)
    # the script draws 2 x draws and keeps the first draws: the same values
    items = rng.zipf(ADMM_SHAPE["a"], draws) % ncols
    # binarised: repeated (user, item) draws collapse; rows ascend by key
    keys = np.unique(users * ncols + items)
    indptr = np.zeros(nrows + 1, np.int64)
    np.cumsum(np.bincount(keys // ncols, minlength=nrows), out=indptr[1:])
    return CSR.from_arrays(nrows, ncols, indptr, keys % ncols, None)


def _fit64(T, W):
    """||R - RW||² from the Gram identity, in float64 on the card."""
    T, W = T.double(), W.double()
    return (torch.trace(T) - 2.0 * (T * W.T).sum()
            + (W * (T @ W)).sum()).item()


def run_admm(dev):
    """Phase 9: ADMM through api.learn at scripts/admm_bench.py's regime,
    held to the card's float64 version (tests/test_admm.py's bar: W atol
    2e-2, fit within 1e-3 rel), zero diagonal, W >= 0; the factor and the
    iterations timed on the same Gram against the iteration's bound (one
    2 npad^3 product over the FP32 peak: pin_f32 forbids TF32); then the
    ML-1M shape against the JAX package's objective and nnz."""
    from slim_tpu_torch import SlimConfig, learn
    from slim_tpu_torch.datagen import synth_implicit
    from slim_tpu_torch.ops.gram import compute_gram
    from slim_tpu_torch.solvers import admm as A

    trn, gen_s = _timed(admm_workload)
    cfg = SlimConfig(dbglvl=2, **ADMM_CFG)
    model, stats = learn(trn, cfg, device=dev)
    n = trn.ncols
    npad = A._round_up(n + 1, 128)
    T = compute_gram(trn, "device", pad_to=npad, device=dev)
    (P, Am), factor_s = _timed(lambda: A.admm_factor(T, cfg.l2r))
    _, iter_s = _timed(lambda: A.admm_iterate(P, Am, cfg.l1r))
    del P, Am
    W64 = A.admm_solve_f64(T, cfg.l1r, cfg.l2r)[:n, :n]
    W64 = torch.where(W64 > 0, W64, 0.0)
    W = torch.from_numpy(model.to_dense()).to(dev)
    Tn = T[:n, :n]
    fit, fit64 = _fit64(Tn, W), _fit64(Tn, W64)
    out = dict(nrows=trn.nrows, ncols=n, nnz=trn.nnz, datagen_s=gen_s,
               learn_s=stats["learn_s"], phases=stats["phases"],
               objective=stats["loss"], model_nnz=stats["nnz"],
               factor_s=factor_s, iterate_s=iter_s,
               ms_per_iteration=1e3 * iter_s / A.MAXITERS,
               iteration_bound_ms=2.0 * npad ** 3 / FP32_FLOPS * 1e3,
               max_abs_err_f64=(W.double() - W64).abs().max().item(),
               fit=fit, fit_f64=fit64,
               max_abs_diag=torch.diagonal(W).abs().max().item())
    del T, W, W64, Tn
    ml1m = synth_implicit(*ML1M_SHAPE, seed=0)
    _, st = learn(ml1m, SlimConfig(algo="admm", l1r=1.0, l2r=1.0), device=dev)
    out["ml1m"] = dict(learn_s=st["learn_s"], phases=st["phases"],
                       objective=st["loss"], model_nnz=st["nnz"])
    print("admm:", json.dumps(out))
    check(out["max_abs_err_f64"] <= 2e-2,
          f"ADMM W differs from float64 by {out['max_abs_err_f64']}")
    check(abs(fit - fit64) <= 1e-3 * fit64, f"ADMM fit {fit} vs {fit64}")
    check(out["max_abs_diag"] < 1e-3, "ADMM diagonal not zero")
    check(model.nnz and model.values().min() > 0, "ADMM model has W <= 0")
    _check_same_fit("ML-1M ADMM", st, ML1M_ADMM_OBJ, ML1M_ADMM_NNZ)
    return out


def run_grid(dev):
    """Phase 10: mselect_grid(parallel=True) at the ML-1M shape over
    GRID_L1 x GRID_L2, the test set a held-out draw.  Each point against a
    cold estimate_model_cd of it on the card (objective rtol 1e-4, nnz
    ±1%), the (1, 1) point against the JAX package's; HR / ARHR within
    ±0.015 / ±0.010 of the sequential walk over the same points, the same
    best pair; cols/s of both."""
    from slim_tpu_torch import SlimConfig
    from slim_tpu_torch.datagen import synth_implicit
    from slim_tpu_torch.mselect import mselect_grid
    from slim_tpu_torch.solvers.cd import estimate_model_cd

    trn = synth_implicit(*ML1M_SHAPE, seed=0)
    tst = synth_implicit(trn.nrows, trn.ncols, trn.nrows, seed=1)
    cfg = SlimConfig(**ML1M_CFG)
    counts0 = _launch_counts()
    # each point's evaluation on the card's dense route, as before phase 14
    # added the native one (unpinned, the packed grid's would take it)
    with env(SLIM_PREDICT_NATIVE_NPAD="0"):
        par = mselect_grid(trn, tst, cfg, GRID_L1, GRID_L2, parallel=True,
                           device=dev)
        packed_launches = _since(counts0)
        seq = mselect_grid(trn, tst, cfg, GRID_L1, GRID_L2, device=dev)
    cols = len(par["results"]) * trn.ncols
    seq_s = sum(r["time"] for r in seq["results"])
    out = dict(points=len(par["results"]), cols=cols,
               grid_s=par["grid_time"], cols_per_s=cols / par["grid_time"],
               sequential_s=seq_s, sequential_cols_per_s=cols / seq_s,
               packed_launches={k: v for k, v in packed_launches.items()
                                if v},
               best=(par["bestl1HR"], par["bestl2HR"]),
               best_sequential=(seq["bestl1HR"], seq["bestl2HR"]))
    pts = []
    for rp, rs in zip(par["results"], seq["results"]):
        pt = (rp["l1r"], rp["l2r"])
        _, cold = estimate_model_cd(trn, cfg.replace(l1r=pt[0], l2r=pt[1]),
                                    device=dev)
        pts.append(dict(l1r=pt[0], l2r=pt[1], objective=rp["loss"],
                        model_nnz=rp["nnz"], sweeps=rp["sweeps"],
                        niters=rp["niters"], hr=rp["hr"], arhr=rp["arhr"],
                        cold_objective=cold["loss"], cold_nnz=cold["nnz"],
                        sequential_hr=rs["hr"], sequential_arhr=rs["arhr"]))
    out["per_point"] = pts
    print("grid:", json.dumps(out))
    check(packed_launches["cd_sweep"] and packed_launches["pack"],
          f"the packed grid launched {packed_launches}")
    for pt in pts:
        tag = f"grid ({pt['l1r']}, {pt['l2r']})"
        _check_same_fit(tag, dict(loss=pt["objective"], nnz=pt["model_nnz"]),
                        pt["cold_objective"], pt["cold_nnz"])
        check(abs(pt["hr"] - pt["sequential_hr"]) <= 0.015
              and abs(pt["arhr"] - pt["sequential_arhr"]) <= 0.010,
              f"{tag} HR / ARHR off the sequential walk: {pt}")
        if (pt["l1r"], pt["l2r"]) == (1.0, 1.0):
            _check_same_fit(tag, dict(loss=pt["objective"],
                                      nnz=pt["model_nnz"]), ML1M_OBJ, ML1M_NNZ)
    check(out["best"] == out["best_sequential"],
          f"grid best {out['best']} vs sequential {out['best_sequential']}")
    return out


def check_harvest_grid(dev, rec):
    """Phase 10's harvest check, run after its launch counts are read:
    estimate_grid_cd over the same points at the ML-1M shape, its entries
    held on the card and moved to host memory at the first block (the
    card's budget patched to 0), every point's model equal entry for
    entry and its stats bit-equal; each pass's seconds and phases
    printed."""
    from slim_tpu_torch import SlimConfig
    from slim_tpu_torch.datagen import synth_implicit
    from slim_tpu_torch.solvers import cd as C

    trn = synth_implicit(*ML1M_SHAPE, seed=0)
    cfg = SlimConfig(**ML1M_CFG)
    points = [(l1, l2) for l1 in GRID_L1 for l2 in GRID_L2]
    held, t_held = _timed(lambda: C.estimate_grid_cd(trn, cfg, points,
                                                     device=dev))
    with patched(C, _card_budget=lambda d: 0):
        moved, t_moved = _timed(lambda: C.estimate_grid_cd(
            trn, cfg, points, device=dev))
    out = dict(held=dict(grid_s=t_held, phases=held[0][1]["phases"]),
               moved=dict(grid_s=t_moved, phases=moved[0][1]["phases"]))
    print("grid harvest:", json.dumps(out), flush=True)
    for pt, got, ref in zip(points, moved, held):
        _same_learn(f"grid {pt} moved to host memory", got, ref)
    rec["harvest"] = out
    return rec


def run_grid_ml20m(dev, trn, cold22):
    """Phase 10b: estimate_grid_cd over GRID_ML20M on the ML-20M matrix
    (every block on v4): (1, 1) against the JAX package's objective and
    nnz, (2, 2) against phase 5's cold (2, 2) point."""
    from slim_tpu_torch import SlimConfig
    from slim_tpu_torch.solvers.cd import estimate_grid_cd

    (res, t) = _timed(lambda: estimate_grid_cd(
        trn, SlimConfig(**ML20M_CFG), GRID_ML20M, device=dev))
    out = dict(grid_s=t, cols_per_s=len(GRID_ML20M) * trn.ncols / t,
               phases=res[0][1]["phases"],
               per_point=[dict(l1r=pt[0], l2r=pt[1], objective=st["loss"],
                               model_nnz=st["nnz"], sweeps=st["sweeps"],
                               niters=st["niters"])
                          for pt, (_, st) in zip(GRID_ML20M, res)])
    print("grid_ml20m:", json.dumps(out))
    check_gates("grid (1, 1)", res[1][1])
    _check_same_fit("grid (2, 2)", res[0][1], cold22["objective"],
                    cold22["model_nnz"])
    return out


def _block_files(ckdir):
    """{block: path} of a checkpoint directory."""
    import glob

    return {int(f.rsplit("_", 1)[1][:-4]): f
            for f in glob.glob(os.path.join(ckdir, "cdblk_*.npz"))}


def run_checkpoint(dev, trn, phase4):
    """Phase 11: the ML-20M learn with checkpoint_dir, against phase 4;
    a third of the block files deleted and the learn resumed (the sweep
    and pack counters show work for those blocks only; the model equal to
    the first: restored blocks exactly, re-solved blocks measured); a full
    restore (no sweep, no pack); the directory removed."""
    import shutil
    import tempfile

    from slim_tpu_torch import SlimConfig, learn

    ckdir = tempfile.mkdtemp(prefix="slim_ckpt_")
    cfg = SlimConfig(l1r=1.0, l2r=1.0, dbglvl=2, checkpoint_dir=ckdir,
                     **ML20M_CFG)
    try:
        runs = []

        def one():
            c0 = _launch_counts()
            model, stats = learn(trn, cfg, device=dev)
            runs.append(dict(learn_s=stats["learn_s"], phases=stats["phases"],
                             sweeps=stats["sweeps"], objective=stats["loss"],
                             model_nnz=stats["nnz"],
                             launches={k: v for k, v in _since(c0).items()
                                       if v}))
            return model, stats

        m1, s1 = one()
        check_gates("checkpointed learn", s1)
        _check_same_fit("checkpointed learn", s1, phase4["objective"],
                        phase4["model_nnz"])
        files = _block_files(ckdir)
        lost = sorted(files)[::3]
        before = {}
        for b in lost:
            with np.load(files[b]) as z:
                before[b] = {k: z[k] for k in z.files}
            os.remove(files[b])
        m2, _ = one()
        diff = []
        for b in lost:
            with np.load(_block_files(ckdir)[b]) as z:
                same = all(np.array_equal(z[k], before[b][k])
                           for k in ("coord", "target"))
                diff.append(float(np.abs(z["vals"] - before[b]["vals"]).max())
                            if same else float("inf"))
        m3, _ = one()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    bit_equal = m2 == m1 and np.array_equal(m2.values(), m1.values())
    out = dict(blocks=len(files), lost=len(lost), runs=runs,
               resolved_max_abs_diff=max(diff), resolved_bit_equal=bit_equal,
               write_s=runs[0]["phases"].get("checkpoint"),
               restore_s=runs[2]["phases"].get("restore"))
    print("checkpoint:", json.dumps(out))
    r1, r2, r3 = runs
    want = sum(int(before[b]["sweeps"]) for b in lost)
    check(r2["launches"].get("cd_sweep_large", 0) == want
          and r2["launches"].get("pack", 0) == len(lost),
          f"resume launched {r2['launches']}, the lost blocks took {want} "
          f"sweeps in {len(lost)} blocks")
    check(not any(r3["launches"].get(k) for k in
                  ("cd_sweep", "pack") + WIDE_SWEEPS),
          f"full restore launched {r3['launches']}")
    check(max(diff) <= CKPT_RESOLVE_ATOL,
          f"re-solved blocks differ by {max(diff)}")
    check(m3 == m2 and np.array_equal(m3.values(), m2.values()),
          "full restore differs from the resumed model")
    return out


def run_api(dev):
    """Phase 12: the classes at the ML-1M shape: SLIMatrix from (user,
    item, rating) triplets, SLIM.train -> predict (no device: the card)
    -> save_model / load_model -> predict, against api.learn + get_topn
    on the same matrix (``checks.ranked_mismatches``), the matrix's ids
    uploaded once for all of them; the loaded model equal to the saved
    one (structure and labels exactly, values to the csr text's 6 digits,
    1e-5 rel); a learn with profile_dir writes a trace that names the
    sweep kernel."""
    import glob
    import shutil
    import tempfile

    from slim_tpu_torch import SLIM, SLIMatrix, SlimConfig, get_topn, learn
    from slim_tpu_torch.checks import ranked_mismatches
    from slim_tpu_torch.datagen import synth_implicit

    mat = synth_implicit(*ML1M_SHAPE, seed=0)
    rows = np.repeat(np.arange(mat.nrows), np.diff(mat.indptr))
    trip = np.stack([rows + 1, mat.indices + 1, np.ones(mat.nnz)], axis=1)
    (sm, mat_s) = _timed(lambda: SLIMatrix(trip))
    cfg = SlimConfig(l1r=1.0, l2r=1.0, **ML1M_CFG)
    tmp = tempfile.mkdtemp(prefix="slim_api_")
    try:
        model = SLIM()
        # no device: the card, as a user calls them ("cuda", the pack's
        # tensors "cuda:0"); the matrix's ids must go up once
        _, train_s = _timed(lambda: model.train(cfg, sm))
        (got, pred_s) = _timed(lambda: model.predict(
            sm, nrcmds=10, returnscores=True))
        users = list(sm.user2id)
        ids = np.stack([got[0][u] for u in users])
        sc = np.stack([got[1][u] for u in users])
        fm, _ = learn(sm.mat, cfg, device=dev)
        fids, fsc, fcnt = get_topn(fm, sm.mat, nrcmds=10, sparse=False,
                                   device=dev)
        flab = np.where(fids >= 0, sm.id2item[np.maximum(fids, 0)], -1)
        agree = ranked_mismatches(ids, sc, flab, fsc, fcnt)
        uploads = sorted(k[0] for k in sm.mat._dev if k[1] == "idx32")
        mfile, mapfile = (os.path.join(tmp, f) for f in ("m.csr", "m.map"))
        model.save_model(mfile, mapfile)
        loaded = SLIM()
        loaded.load_model(mfile, mapfile)
        a, b = model.model, loaded.model
        same = a.shape == b.shape and np.array_equal(a.indptr, b.indptr) \
            and np.array_equal(a.indices, b.indices) \
            and np.array_equal(loaded.id2item, model.id2item)
        rel = float(np.abs(b.values() / a.values() - 1.0).max()) \
            if same else float("inf")
        with env(SLIM_PREDICT_NATIVE_NPAD="0"):   # the card's dense route
            again = loaded.predict(sm, nrcmds=10, returnscores=True,
                                   device=dev)
        reload_agree = ranked_mismatches(
            np.stack([again[0][u] for u in users]),
            np.stack([again[1][u] for u in users]), ids, sc)
        prof = os.path.join(tmp, "prof")
        learn(sm.mat, cfg.replace(profile_dir=prof), device=dev)
        trace = open(glob.glob(os.path.join(prof, "*.json"))[0]).read()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = dict(users=sm.nUsers, items=sm.nItems, slimatrix_s=mat_s,
               train_s=train_s, predict_s=pred_s,
               objective=model.stats["loss"], model_nnz=model.model.nnz,
               ids_differ=agree[0], ids_differ_off_near_ties=agree[1],
               reload_ids_differ_off_near_ties=reload_agree[1],
               loaded_structure_equal=bool(same),
               loaded_max_rel_diff=rel, trace_bytes=len(trace),
               trace_names_sweep="group_kernel" in trace,
               idx32_uploads=uploads)
    print("api:", json.dumps(out))
    check(uploads == ["cuda:0"], f"the matrix's ids went up as {uploads}: "
          "one card, one upload")
    check(agree[1] == 0, f"class predict differs from get_topn: {agree}")
    check(rel <= 1e-5, "the loaded model differs from the saved one "
          "beyond the csr text's 6 digits")
    check(reload_agree[1] == 0, f"predict after load differs: {reload_agree}")
    check(out["trace_names_sweep"], "the profile trace names no sweep kernel")
    _check_same_fit("class ML-1M learn", dict(loss=out["objective"],
                                              nnz=out["model_nnz"]),
                    ML1M_OBJ, ML1M_NNZ)
    return out


DEVICE_ROUTES = ("dense", "rows", "coo")


def _same_runs(tag, got, ref):
    """Two ranked (ids, scores, counts) of the same users, summed in
    another order (another route, or weights rounded by the csr text),
    where an exact tie on one side can be an ulp apart on the other: the
    same counts, scores within 1e-5 rel, and ids equal up to the order
    within runs of scores equal within 1e-5
    (``checks.tie_order_mismatches``)."""
    from slim_tpu_torch.checks import tie_order_mismatches

    check(np.array_equal(got[2], ref[2]), f"{tag}: counts differ")
    check(np.allclose(got[1], ref[1], rtol=1e-5, atol=1e-6),
          f"{tag}: scores differ")
    off = tie_order_mismatches(got[0], ref[0], ref[1], ref[2])[1]
    check(off == 0, f"{tag}: {off} ids differ")


def _check_guide(shape, rec, ml1m):
    """The walkthrough's gates at ``shape`` (see run_guide)."""
    tag = f"guide {shape}"
    for name, r in rec["ingestion"].items():
        check(r is None or r["same"], f"{tag}: {name} ingestion differs")
    p, sl = rec["predict"], rec["save_load"]
    full = np.full(len(p["ids"]), p["ids"].shape[1])
    _same_runs(f"{tag} save/load", (sl["ids"], sl["scores"], full),
               (p["ids"], p["scores"], full))
    ms = rec["mselect"]
    check(ms["best"] == ms["grid_best"],
          f"{tag}: walk best {ms['best']} vs packed grid {ms['grid_best']}")
    f = rec["functional"]
    for key in ("gram_device_loss", "checkpoint_loss", "resumed_loss"):
        check(abs(rec["knobs"][key] - f["loss"]) <= 1e-4 * f["loss"],
              f"{tag}: {key} {rec['knobs'][key]} vs {f['loss']}")
    check("restore" in rec["knobs"]["resumed_phases"]
          and rec["knobs"]["traces"] == 1, f"{tag}: knobs {rec['knobs']}")
    sv = rec["serving"]
    check_agree(f"{tag} serving pack", sv["pack"], sv["dense"])
    for form in ("sparse_rows", "sparse", "native"):
        if form in sv:
            _same_runs(f"{tag} serving {form}", sv[form], sv["dense"])
    check(sv["pack_route"] == sv["dense_route"] == "dense"
          and sv["sparse_rows_route"] == sv["sparse_route"] == "rows",
          f"{tag}: serving routes")
    world = rec["distributed"]
    routes = [r["mselect_route"] for r in world]
    check(routes[0] in DEVICE_ROUTES and routes[1:] == [None],
          f"{tag}: the mesh walk evaluated on routes {routes}")
    for mode in ("replicated", "blockwise", "sharded_g"):
        check(all(r[mode]["model"] == world[0][mode]["model"]
                  for r in world), f"{tag}: {mode} ranks differ")
    if shape == "guide":
        for key, (loss, nnz) in GUIDE_FITS.items():
            if key != "dist":
                _check_same_fit(f"{tag} {key}", rec[key], loss, nnz)
        for mode in ("replicated", "blockwise", "sharded_g"):
            _check_same_fit(f"{tag} {mode}", world[0][mode],
                            *GUIDE_FITS["dist"])
        check(abs(f["hr"] - GUIDE_EVAL[0]) <= 0.015
              and abs(f["arhr"] - GUIDE_EVAL[1]) <= 0.010,
              f"{tag}: HR / ARHR {f['hr']} / {f['arhr']}")
        for g, (l1, l2, nnz, hr, arhr) in zip(ms["points"], GUIDE_MSELECT):
            check((g["l1r"], g["l2r"]) == (l1, l2)
                  and abs(g["nnz"] - nnz) <= 0.01 * nnz
                  and abs(g["hr"] - hr) <= 0.015
                  and abs(g["arhr"] - arhr) <= 0.010,
                  f"{tag}: mselect point {g}")
        check(ms["best"] == GUIDE_BEST, f"{tag}: best {ms['best']}")
    else:
        # the class model is the functional learn of the same config
        check(abs(rec["train"]["loss"] - f["loss"]) <= 1e-4 * f["loss"],
              f"{tag}: class {rec['train']['loss']} vs learn {f['loss']}")
        for mode in ("replicated", "blockwise", "sharded_g"):
            st = world[0][mode]
            check(abs(st["loss"] - ml1m["objective"])
                  <= DIST_OBJ_RTOL * ml1m["objective"]
                  and abs(st["nnz"] - ml1m["model_nnz"])
                  <= DIST_NNZ_RTOL * ml1m["model_nnz"],
                  f"{tag} {mode}: {st['loss']} / {st['nnz']} vs phase 3b's "
                  f"{ml1m['objective']} / {ml1m['model_nnz']}")


def run_guide(dev, ml1m):
    """Phase guide: docs/userguide_torch.py, every public entry point, on
    cuda:0 at its guide shape (120 x 60, docs/userguide.py's data) and at
    the ML-1M shape.  Each section's wall time and launches are printed
    (section 9's in its two gloo ranks on the card).  Gates at both: each
    ingestion path gives the matrix; the save / load round trip keeps the
    lists; the walk and the packed grid pick one best pair; the knobs'
    learns (device Gram, checkpoint and resume) give the functional fit;
    every serving form the dense lists; the mesh walk scores on rank 0's
    device route only; every rank the same distributed models.  At the
    guide shape every fit, HR / ARHR and mselect point against the JAX
    package's (GUIDE_*); at the ML-1M shape the class model against the
    functional learn (objective 1e-4 rel) and every distributed learn
    within DIST_OBJ_RTOL / DIST_NNZ_RTOL of phase 3b's."""
    sys.path.insert(0, os.path.join(HERE, "docs"))
    import userguide_torch as guide

    out = {}
    for shape in ("guide", "ml1m"):
        rec, secs = _timed(lambda: guide.main(device="cuda:0", shape=shape))
        for name, s in rec["sections"].items():
            print(f"guide {shape} section {name}: {s['seconds']:.3f}s, "
                  "launches", json.dumps({k: v for k, v in
                                          s["launches"].items() if v}),
                  flush=True)
        ranks = [{k: v for k, v in r["launches"].items() if v}
                 for r in rec["distributed"]]
        print(f"guide {shape} section 9 ranks' launches", json.dumps(ranks),
              flush=True)
        _check_guide(shape, rec, ml1m)
        f = rec["functional"]
        out[shape] = dict(
            seconds=secs, sections={k: s["seconds"]
                                    for k, s in rec["sections"].items()},
            rank_launches=ranks, train=rec["train"]["loss"],
            functional=(f["loss"], f["nnz"], f["hr"], f["arhr"]),
            best=rec["mselect"]["best"],
            dist={m: rec["distributed"][0][m]["loss"]
                  for m in ("replicated", "blockwise", "sharded_g")},
            save_load_route=rec["save_load"]["route"],
            unpinned_few_route=rec["serving"]["unpinned_few_route"])
        print(f"guide {shape}:", json.dumps(out[shape]), flush=True)
    return out


# phase 14, the native host runtime: the ML-1M-shaped native CD runs when
# the synth set's time, scaled by columns x ratings, predicts it within
# NATIVE_ML1M_BUDGET_S; phase 4's model is cut into NATIVE_FRAGMENTS
# shuffled COO fragments for the assembly; the predict comparison on
# phase 4's SLIM model takes its first NATIVE_HEAD users (each user's work
# on the host is ~30x the FSLIM model's there).  The route's crossover:
# the ML-1M shape's model cut to its first NATIVE_SUB_ITEMS items (the most
# popular), with every user and with the first NATIVE_FEW, and the first
# NATIVE_FEW users of the ML-1M shape and of the FSLIM model.  Wherever one
# of the two routes is more than ROUTE_MARGIN x faster than the other, the
# unpinned call must take it.
NATIVE_ML1M_BUDGET_S = 60.0
NATIVE_FRAGMENTS = 27
NATIVE_HEAD = 16384
NATIVE_SUB_ITEMS = (383, 767, 1535)       # npad 384, 768, 1536
NATIVE_FEW = 600
ROUTE_MARGIN = 1.25
NATIVE_ROUNDS = 7


def _in_turns(fns, under_s=0.5, rounds=NATIVE_ROUNDS):
    """The results of ``fns`` and each one's times: every fn timed once,
    in turn, and when that round took under ``under_s``, ``rounds`` - 1
    more rounds in the same turns.  A call of a few milliseconds varies by ~2x
    on the card's shared host, also between the best of three runs in a
    row, so the routes compared take turns and each keeps its least."""
    res, first = zip(*(_timed(f) for f in fns))
    secs = [[t] for t in first]
    if sum(first) < under_s:
        for _ in range(rounds - 1):
            for f, t in zip(fns, secs):
                t.append(_timed(f)[1])
    return res, secs


def _sub_catalogue(model, hist, k):
    """``model`` and ``hist`` cut to their first ``k`` items."""
    from slim_tpu_torch.types import CSR

    return (CSR.from_scipy(model.to_scipy()[:k, :k]),
            CSR.from_scipy(hist.to_scipy()[:, :k]))


def _native_vs_card(tag, model, hist, dev):
    """Phase 14's predict comparison on one model: the native route and the
    card's dense route on the same users, each timed, the card's both as
    an unpinned call pays it (the model densified in the call) and with
    the model resident (as a server holds it); the same counts, scores
    within 1e-5 rel, ids equal up to the order within runs of equal
    scores (``checks.tie_order_mismatches``); then the route an unpinned
    call takes, its time, and whether it is the faster one (``route_ok``:
    always, when neither is ROUTE_MARGIN x faster).  The four calls take
    turns (``_in_turns``), each timed as its least."""
    from slim_tpu_torch import native
    from slim_tpu_torch import predict as P
    from slim_tpu_torch.checks import tie_order_mismatches

    W, dens_s = _timed(lambda: P.densify_model(model, device=dev))
    P.predict_topn(model, _head_rows(hist, 256), nrcmds=10, W_dev=W,
                   device=dev)                                   # warm
    routes = set()

    def unpinned():
        P.predict_topn(model, hist, nrcmds=10, device=dev)
        routes.add(P.last_route)

    (nat, card, _, _), secs = _in_turns([
        lambda: native.predict_topn(model, hist, nrcmds=10),
        lambda: P.predict_topn(model, hist, nrcmds=10, W_dev=W, device=dev),
        lambda: P.predict_topn(model, hist, nrcmds=10, sparse=False,
                               device=dev),
        unpinned])
    del W
    nat_s, card_s, call_s, unpinned_s = map(min, secs)
    check(len(routes) == 1, f"{tag}: unpinned calls took {routes}")
    route = routes.pop()
    differ, bad = tie_order_mismatches(nat[0], *card)
    n = max(model.nrows, model.ncols, hist.ncols)
    faster = "native" if nat_s < call_s else "dense"
    out = dict(users=hist.nrows, items=n, model_nnz=model.nnz,
               hist_nnz=hist.nnz,
               work_per_user=(hist.nnz / hist.nrows)
               * (model.nnz / model.nrows),
               score_updates=P.native_predict_work(model, hist),
               native_s=nat_s, native_users_per_s=hist.nrows / nat_s,
               card_call_s=call_s, card_call_users_per_s=hist.nrows / call_s,
               card_dense_s=card_s, card_dense_users_per_s=hist.nrows / card_s,
               card_model_densify_s=dens_s, unpinned_route=route,
               unpinned_s=unpinned_s, faster=faster,
               route_ok=route == faster
               or max(nat_s, call_s) <= ROUTE_MARGIN * min(nat_s, call_s),
               native_runs_s=secs[0], card_call_runs_s=secs[2],
               ids_differ=differ, ids_differ_off_tie_runs=bad)
    print(f"native predict {tag}:", json.dumps(out), flush=True)
    check(np.array_equal(nat[2], card[2]), f"{tag}: counts differ")
    check(np.allclose(nat[1], card[1], rtol=1e-5, atol=1e-6),
          f"{tag}: scores differ")
    check(bad == 0, f"{tag}: {bad} ids differ off runs of equal scores")
    return out


def _native_assembly(model, dev):
    """Phase 4's model as NATIVE_FRAGMENTS shuffled COO fragments,
    assembled by ``native.csr_from_blocks`` (the native counting sort, on
    host arrays) and by the learn's ``solvers.cd._assemble`` (the sort on
    the card, the fragments uploaded first; in turns, twice each): both
    equal to the model entry for entry."""
    from slim_tpu_torch import native
    from slim_tpu_torch.solvers.cd import _assemble
    from slim_tpu_torch.types import CSR

    rows = np.repeat(np.arange(model.nrows, dtype=np.int32),
                     np.diff(model.indptr))
    cuts = np.array_split(np.random.default_rng(14).permutation(model.nnz),
                          NATIVE_FRAGMENTS)
    frags = ([rows[c] for c in cuts], [model.indices[c] for c in cuts],
             [model.data[c] for c in cuts])
    del rows
    on_card = [[torch.from_numpy(a).to(dev) for a in lst] for lst in frags]
    fns = {"native": lambda: CSR.from_arrays(
               model.nrows, model.nrows,
               *native.csr_from_blocks(*frags, model.nrows)),
           "card": lambda: _assemble(*on_card, model.nrows)}
    secs = {"native": [], "card": []}
    for kind in ("native", "card", "card", "native"):
        got, t = _timed(fns[kind])
        secs[kind].append(t)
        check(np.array_equal(got.indptr, model.indptr)
              and np.array_equal(got.indices, model.indices)
              and np.array_equal(got.data, model.data),
              f"the {kind} assembly differs from the model")
    del on_card
    return dict(entries=model.nnz, fragments=NATIVE_FRAGMENTS,
                native_s=secs["native"], card_s=secs["card"])


def check_cd_small(dev, rec):
    """Phase 14's last check, run after its launch counts are read (its
    learn launches the CD kernels): the CD learn (l1r = l2r = 1, optTol
    1e-7, block_size 1024) on the card and the native all-core CPU
    solver on a synthetic ml100k-shaped matrix (943 x 1,682, 100k
    ratings 1-5, the items by ``datagen.zipf``, so it is the same matrix
    under any numpy), the card's objective within 1e-4 rel of the
    native solver's; each one's seconds, objective and model nnz
    printed."""
    from slim_tpu_torch import SlimConfig, learn, native
    from slim_tpu_torch.datagen import zipf
    from slim_tpu_torch.types import CSR

    rng = np.random.default_rng(0)
    nrows, ncols, nnz = 943, 1682, 100000
    users = rng.integers(0, nrows, nnz)
    items = (zipf(rng, 1.3, nnz * 2) % ncols)[:nnz]
    vals = rng.integers(1, 6, nnz).astype(np.float32)
    trn = CSR.from_ijv(users, items, vals, nrows, ncols).infer_ncols()
    kw = dict(l1r=1.0, l2r=1.0, optTol=1e-7, maxniters=10000)
    (model, stats), t = _timed(lambda: learn(
        trn, SlimConfig(block_size=1024, **kw), device=dev))
    (cpu_model, _, cpu_obj), cpu_t = _timed(
        lambda: native.cd_learn(trn, nthreads=0, **kw))
    out = dict(shape=[trn.nrows, trn.ncols, trn.nnz], learn_s=t,
               objective=stats["loss"], model_nnz=model.nnz,
               cpu_learn_s=cpu_t, cpu_objective=cpu_obj,
               cpu_model_nnz=cpu_model.nnz, cpu_threads=os.cpu_count())
    print("native cd small:", json.dumps(out), flush=True)
    check(abs(out["objective"] - cpu_obj) <= 1e-4 * abs(cpu_obj),
          f"the card's objective {out['objective']} vs the native CPU "
          f"solver's {cpu_obj}")
    rec["cd_small"] = out
    return rec


def run_native(dev, trn, build_s, phase4):
    """Phase 14: the native host runtime on the card's host (see the
    module docstring).  ``trn``: the ML-20M matrix; ``phase4``: phase 4's
    record."""
    import shutil
    import tempfile

    from slim_tpu_torch import native
    from slim_tpu_torch.datagen import synth_implicit
    from slim_tpu_torch.io import readers
    from slim_tpu_torch.ops.gram import compute_gram
    from slim_tpu_torch.solvers.cd import bucket_npad

    out = dict(build_s=build_s, cpu_count=os.cpu_count(),
               cpus_usable=len(os.sched_getaffinity(0)),
               library=native.library_path().name)
    print("native build:", json.dumps(out), flush=True)

    # CD: the synth goldens, then the ML-1M shape when it fits the budget
    syn = readers.read_matrix(os.path.join(HERE, "tests", "data",
                                           "synth-train.ijv"),
                              fmt="ijv").infer_ncols()
    cd_kw = dict(l1r=1.0, l2r=1.0, optTol=1e-7, maxniters=10000)
    (m, _, obj), t = _timed(lambda: native.cd_learn(syn, **cd_kw))
    out["cd_synth"] = dict(s=t, objective=obj, model_nnz=m.nnz)
    print("native cd synth:", json.dumps(out["cd_synth"]), flush=True)
    _check_same_fit("native CD synth", dict(loss=obj, nnz=m.nnz),
                    SYNTH_LOSS, SYNTH_NNZ)
    m1 = synth_implicit(*ML1M_SHAPE, seed=0)
    guess = t * (m1.ncols * m1.nnz) / (syn.ncols * syn.nnz)
    if guess <= NATIVE_ML1M_BUDGET_S:
        (m, _, obj), t = _timed(lambda: native.cd_learn(m1, **cd_kw))
        out["cd_ml1m"] = dict(s=t, predicted_s=guess, objective=obj,
                              model_nnz=m.nnz)
        print("native cd ml1m:", json.dumps(out["cd_ml1m"]), flush=True)
        _check_same_fit("native CD ML-1M", dict(loss=obj, nnz=m.nnz),
                        ML1M_OBJ, ML1M_NNZ)
    else:
        out["cd_ml1m"] = dict(left_out=True, predicted_s=guess)
        print(f"native cd ml1m: left out, the synth set's time scaled by "
              f"columns x ratings predicts {guess:.1f} s, over the "
              f"{NATIVE_ML1M_BUDGET_S} s budget", flush=True)

    # the assembly of phase 4's model, native and on the card
    out["assembly"] = _native_assembly(_KEPT["ml20m"], dev)
    out["assembly"]["phase4_assembly_s"] = phase4["phases"].get("assembly")
    print("native assembly:", json.dumps(out["assembly"]), flush=True)

    # the predict routes, native against the card's dense one, on the
    # four models and at the crossover's shapes
    cases = {"synth": (_KEPT["synth"], syn),
             "ml1m": (_KEPT["ml1m"], m1),
             "fslim_ml20m": (_KEPT["fslim"], trn),
             "slim_ml20m_head": (_KEPT["ml20m"], _head_rows(trn, NATIVE_HEAD)),
             f"ml1m_first{NATIVE_FEW}": (_KEPT["ml1m"],
                                         _head_rows(m1, NATIVE_FEW)),
             f"fslim_ml20m_first{NATIVE_FEW}": (_KEPT["fslim"],
                                                _head_rows(trn, NATIVE_FEW))}
    for k in NATIVE_SUB_ITEMS:
        sm, sh = _sub_catalogue(_KEPT["ml1m"], m1, k)
        cases[f"ml1m_items{k}"] = (sm, sh)
        cases[f"ml1m_items{k}_first{NATIVE_FEW}"] = (
            sm, _head_rows(sh, NATIVE_FEW))
    out["predict"] = {tag: _native_vs_card(tag, *mh, dev)
                      for tag, mh in cases.items()}
    wrong = {k: (v["unpinned_route"], v["faster"])
             for k, v in out["predict"].items() if not v["route_ok"]}

    # the Gram at the ML-1M shape: host kernel against the card's
    npad = bucket_npad(m1.ncols)
    gh, gh_s = _timed(lambda: native.gram_dense(m1, pad_to=npad))
    gc, gc_s = _timed(lambda: compute_gram(m1, "device", pad_to=npad,
                                           device=dev))
    same = bool(np.array_equal(gc.cpu().numpy(), gh))
    del gc, gh
    out["gram"] = dict(npad=npad, native_s=gh_s, card_s=gc_s, equal=same)
    print("native gram:", json.dumps(out["gram"]), flush=True)
    check(same, "the native Gram differs from the card's")

    # the tokenisers on the ML-1M shape written as a csr file
    tmp = tempfile.mkdtemp(prefix="slim_native_")
    try:
        path = os.path.join(tmp, "ml1m.csr")
        readers.write_matrix(m1, path, fmt="csr")
        with open(path, "rb") as fh:
            raw = fh.read()
        (nt, nl), nat_s = _timed(lambda: native.parse_tokens(raw))
        (pt, pl), np_s = _timed(lambda: readers._tokenise_numpy(raw))
        back = readers.read_matrix(path, fmt="csr")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["tokeniser"] = dict(bytes=len(raw), tokens=int(nt.size),
                            native_s=nat_s, numpy_s=np_s)
    print("native tokeniser:", json.dumps(out["tokeniser"]), flush=True)
    check(np.array_equal(nt, pt) and np.array_equal(nl, pl),
          "the tokenisers differ")
    check(np.array_equal(back.indptr, m1.indptr)
          and np.array_equal(back.indices, m1.indices),
          "the csr file reads back another matrix")

    check(not wrong, f"unpinned calls took the slower route by more than "
          f"{ROUTE_MARGIN}x (route, faster): {wrong}")
    return out


# models kept by name: between phases (for phase 14), and a rank's
# between the calls of one world (phase 13)
_KEPT = {}


def _summary(model, stats, secs, ncols):
    """The printed record of one distributed learn."""
    return dict(learn_s=secs, cols_per_s=ncols / secs,
                objective=stats["loss"], model_nnz=stats["nnz"],
                sweeps=stats["sweeps"], niters=stats["niters"],
                ranks=stats["ndevices"], superblocks=stats.get("superblocks"),
                model_sum=float(model.values().sum(dtype=np.float64)))


def dist_learn(mode, trn, cfg, keep=None, mesh=None):
    """A world's call: one distributed learn (``mode``) on ``mesh``, timed
    to its end on the card; the model kept under ``keep``."""
    from slim_tpu_torch.parallel import dist as D

    fn = {"replicated": D.distributed_learn,
          "blockwise": D.distributed_learn_blockwise,
          "sharded_g": D.distributed_learn_sharded_g}[mode]
    (model, stats), secs = _timed(lambda: fn(trn, cfg, mesh))
    if keep:
        _KEPT[keep] = model
    return _summary(model, stats, secs, trn.ncols)


def dist_grid(trn, tst, cfg, mesh=None):
    """A world's call: mselect_grid(parallel=True, mesh=) over GRID_L1 x
    GRID_L2, without the models, and the route of the rank's predicts in
    it (None where it made none: rank 0 scores every point)."""
    from slim_tpu_torch import mselect_grid, predict

    predict.last_route = None
    res = mselect_grid(trn, tst, cfg, GRID_L1, GRID_L2, parallel=True,
                       mesh=mesh)
    return dict(grid_s=res["grid_time"], best=(res["bestl1HR"],
                                               res["bestl2HR"]),
                per_point=[{k: r[k] for k in ("l1r", "l2r", "loss", "nnz",
                                              "sweeps", "hr", "arhr")}
                           for r in res["results"]],
                route=predict.last_route)


def dist_predict(hist, keep, mesh=None):
    """A world's call: the sharded top-10 of every user of ``hist`` on the
    kept model; the first DIST_HEAD users' lists."""
    from slim_tpu_torch.parallel.dist import sharded_predict

    got, secs = _timed(lambda: sharded_predict(_KEPT[keep], hist, mesh,
                                               nrcmds=10, sparse=False))
    return dict(users=hist.nrows, s=secs, users_per_s=hist.nrows / secs,
                head=tuple(a[:DIST_HEAD] for a in got))


def dist_predict_ref(hist, keep, mesh=None):
    """A world's call, not part of a path: the single-device top-10 of
    the first DIST_HEAD users on the kept model, at "highest" as the
    sharded predict scores."""
    from slim_tpu_torch.parallel.mesh import mesh_device
    from slim_tpu_torch.predict import predict_topn

    return predict_topn(_KEPT[keep], _head_rows(hist, DIST_HEAD), nrcmds=10,
                        sparse=False, precision="highest",
                        device=mesh_device(mesh))


def _ml1m_calls():
    """The ML-1M calls of dist_ml1m / dist_gloo2: the three learns and the
    packed grid on a mesh."""
    from slim_tpu_torch import SlimConfig
    from slim_tpu_torch.datagen import synth_implicit
    from slim_tpu_torch.parallel.launch import Call

    trn = synth_implicit(*ML1M_SHAPE, seed=0)
    tst = synth_implicit(trn.nrows, trn.ncols, trn.nrows, seed=1)
    cfg = SlimConfig(l1r=1.0, l2r=1.0, **ML1M_CFG)
    return [Call(m, dist_learn, (m, trn, cfg))
            for m in ("replicated", "blockwise", "sharded_g")] + \
        [Call("grid", dist_grid, (trn, tst, SlimConfig(**ML1M_CFG)))]


def _fresh(mat):
    """``mat`` without its device caches, to be pickled to the ranks."""
    from slim_tpu_torch.types import CSR

    return CSR.from_arrays(mat.nrows, mat.ncols, mat.indptr, mat.indices,
                           mat.data)


def _same_on_ranks(tag, ranks, key):
    """Every rank's record of ``key`` is the same but for its times."""
    recs = [{k: v for k, v in r[key]["result"].items()
             if k not in ("learn_s", "cols_per_s", "grid_s", "route")}
            for r in ranks]
    check(all(r == recs[0] for r in recs[1:]),
          f"{tag} {key}: ranks differ: {recs}")


def run_dist(trn, phase4):
    """Phase 13: the NCCL world (dist_ml1m, dist_ml20m, dist_2m) and the
    2-rank gloo world (dist_gloo2).  Returns {path: (record, launches
    summed over the ranks)}."""
    from slim_tpu_torch import SlimConfig
    from slim_tpu_torch.datagen import synth_longtail
    from slim_tpu_torch.parallel.launch import Call, run_calls, run_world

    ml1m = _ml1m_calls()
    big = _fresh(trn)
    cfg20 = SlimConfig(l1r=1.0, l2r=1.0, **ML20M_CFG)
    m2, gen_s = _timed(synth_longtail)
    paths = {
        "dist_ml1m": [c.key for c in ml1m],
        "dist_ml20m": ["ml20m_replicated", "ml20m_sharded_g",
                       "ml20m_predict"],
        "dist_2m": ["blockwise_2m"]}
    calls = ml1m + [
        Call("ml20m_replicated", dist_learn, ("replicated", big, cfg20),
             dict(keep="ml20m")),
        Call("ml20m_sharded_g", dist_learn, ("sharded_g", big, cfg20)),
        Call("ml20m_predict", dist_predict, (big, "ml20m")),
        Call("ml20m_predict_ref", dist_predict_ref, (big, "ml20m")),
        Call("blockwise_2m", dist_learn, ("blockwise", m2,
                                          SlimConfig(**DIST_2M_CFG)))]
    torch.cuda.empty_cache()
    nranks = torch.cuda.device_count()
    (nccl, nccl_s) = _timed(lambda: run_world(
        run_calls, nranks, args=(calls, "cuda"), device="cuda",
        timeout_s=900))
    (gloo, gloo_s) = _timed(lambda: run_world(
        run_calls, 2, args=(ml1m, "cuda"), device="cuda", backend="gloo",
        timeout_s=600))
    paths["dist_gloo2"] = paths["dist_ml1m"]

    def record(ranks, keys):
        return {k: dict(ranks[0][k]["result"], seconds=ranks[0][k]["seconds"])
                for k in keys}

    def launches(ranks, keys):
        return {name: sum(r[k]["launches"][name] for r in ranks for k in keys)
                for name in ranks[0][keys[0]]["launches"]}

    out = {}
    for path, keys in paths.items():
        ranks = gloo if path == "dist_gloo2" else nccl
        rec = record(ranks, keys)
        rec["ranks"], rec["world_s"] = len(ranks), (
            gloo_s if path == "dist_gloo2" else nccl_s)
        out[path] = (rec, launches(ranks, keys))
        print(f"{path}:", json.dumps(rec, default=lambda a: "..."),
              flush=True)
        for k in keys:
            if k != "ml20m_predict":      # its lists are checked below
                _same_on_ranks(path, ranks, k)
    out["dist_2m"][0]["datagen_s"] = gen_s

    # gates
    for k in ("ml20m_replicated", "ml20m_sharded_g"):
        st = out["dist_ml20m"][0][k]
        tag = f"dist {k}"
        check_gates(tag, dict(loss=st["objective"], nnz=st["model_nnz"]))
        check(abs(st["objective"] - phase4["objective"])
              <= DIST_OBJ_RTOL * phase4["objective"]
              and abs(st["model_nnz"] - phase4["model_nnz"])
              <= DIST_NNZ_RTOL * phase4["model_nnz"],
              f"{tag}: {st['objective']} / {st['model_nnz']} vs phase 4's "
              f"{phase4['objective']} / {phase4['model_nnz']}")
    pred = out["dist_ml20m"][0]["ml20m_predict"]
    ref = nccl[0]["ml20m_predict_ref"]["result"]
    pred["agree"] = check_agree("dist sharded predict", pred.pop("head"),
                                ref)
    check(pred["users"] == trn.nrows, "sharded predict lost users")
    st = out["dist_2m"][0]["blockwise_2m"]
    check(abs(st["objective"] - AMAZON2M_OBJ) <= 1e-4 * AMAZON2M_OBJ,
          f"2M-item blockwise objective {st['objective']}")
    one, two = out["dist_ml1m"][0], out["dist_gloo2"][0]
    for k in ("replicated", "blockwise", "sharded_g"):
        _check_same_fit(f"dist ML-1M {k}", dict(loss=one[k]["objective"],
                                                nnz=one[k]["model_nnz"]),
                        ML1M_OBJ, ML1M_NNZ)
        check(abs(two[k]["objective"] - one[k]["objective"])
              <= DIST_OBJ_RTOL * one[k]["objective"]
              and abs(two[k]["model_nnz"] - one[k]["model_nnz"])
              <= DIST_NNZ_RTOL * one[k]["model_nnz"],
              f"gloo2 {k} {two[k]} vs one world's {one[k]}")
    for a, b in zip(one["grid"]["per_point"], two["grid"]["per_point"]):
        check(a["nnz"] == b["nnz"] and abs(a["loss"] - b["loss"])
              <= DIST_OBJ_RTOL * a["loss"], f"gloo2 grid {b} vs {a}")
    # the mesh grid's evaluations: rank 0 on a device route, the others
    # none, with the native route on (no pin around the call)
    for tag, ranks in (("dist_ml1m", nccl), ("dist_gloo2", gloo)):
        routes = [r["grid"]["result"]["route"] for r in ranks]
        check(routes[0] in DEVICE_ROUTES and routes[1:] == [None] * (
            len(routes) - 1), f"{tag} grid evaluated on routes {routes}")
    return out


def kernel_checks(dev, trn, profile=None):
    """Phase 2: every kernel against its plain version (see the module
    docstring); returns the check records."""
    rng = np.random.default_rng(0)
    large = _sweep_inputs(dev, rng, 27278, 20000, 2_000_000, 1024, large=True)
    checks = check_densify(dev, rng, trn)
    row = [_sweep_inputs(dev, rng, n, 4 * n, 40 * n, 512, large=False)
           for n in (300, 4000)]
    checks += [check_sweep(row[0]), check_sweep(row[1]),
               check_sweep_large(large, all_active=True),
               check_sweep_large(large, all_active=False),
               check_sweep_panel(large, "v3", all_active=False),
               check_sweep_panel(large, "v3", all_active=True),
               check_sweep_panel(large, "eager", all_active=False),
               check_sweep_panel(large, "eager", all_active=True),
               check_pack(dev, rng),
               # a packed grid block straddling two points (phases 10, 10b)
               check_sweep(mixed_regs(row[1]), note=" mixed regs"),
               check_sweep_large(mixed_regs(large), all_active=False,
                                 note=" mixed regs")]
    flush, feed = check_flush(large)
    print("flush:", json.dumps(flush), flush=True)
    print("flush feed:", json.dumps(feed), flush=True)
    if profile is not None:
        profile_sweep(large, row[1], profile)
    del large, row
    # phase 7's compact FSLIM blocks: B 1024 on unions of up to 4,096 (row
    # 1) and of 6,144-8,192 (row 4), about 50 active coordinates a column
    for n in (2000, 4000):
        checks.append(check_sweep(_sweep_inputs(
            dev, rng, n, 4 * n, 40 * n, 1024, large=False,
            nnbrs=FSLIM_CFG["nnbrs"])))
    checks.append(check_sweep_large(_sweep_inputs(
        dev, rng, 8000, 32000, 320_000, 1024, large=True,
        nnbrs=FSLIM_CFG["nnbrs"]), all_active=False))
    checks += check_gather(dev, rng)
    for c in checks:
        print("check:", json.dumps(c), flush=True)
    return checks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=["kernels", "dist", "native", "cli",
                                       "all"],
                    default="all",
                    help="kernels: stop after the kernel checks; dist: the "
                         "ML-20M learn and the distributed paths only; "
                         "native: the paths whose models phase 14 serves "
                         "(synth, ML-1M, ML-20M, ML-20M FSLIM) and phase 14; "
                         "cli: the three programs only (phase cli)")
    ap.add_argument("--profile", metavar="DIR",
                    help="run one sweep and the ML-20M phase under "
                         "torch.profiler and write their per-kernel device "
                         "times into DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import slim_tpu_torch  # noqa: F401  (fails outside a checkout)
    from slim_tpu_torch import native
    from slim_tpu_torch.datagen import synth_ml20m
    from slim_tpu_torch.ops import _build
    from slim_tpu_torch.ops.gram import pin_f32

    pin_f32()
    dev = torch.device("cuda", 0)
    walls = {}
    t_run = t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        t1 = time.perf_counter()
        walls[name] = t1 - t0
        print(f"phase {name}: {walls[name]:.2f}s", flush=True)
        t0 = t1

    card = card_line()
    print("card:", card, flush=True)
    _build.build()
    _build.lib()
    # the host runtime: a missing C++ compiler fails here, as a failed build
    check(native.compiler() is not None, "no C++ compiler for the native "
          "host runtime")
    native_build_s = _timed(native.lib)[1]
    print(f"native library built in {native_build_s:.2f}s", flush=True)
    lap("build")

    trn = None if args.only == "cli" else synth_ml20m(seed=0)
    lap("datagen")
    checks = [] if args.only in ("dist", "native", "cli") \
        else kernel_checks(dev, trn, args.profile)
    lap("kernels")
    if args.only == "kernels":
        return 0

    wrappers = launch_wrappers()
    results = {}
    drives = (("synth", lambda: run_synth(dev)),
              ("ml1m", lambda: run_ml1m(dev)),
              ("cli", lambda: run_cli(dev)),
              ("ml1m_fslim", lambda: run_ml1m_fslim(dev)),
              ("ml20m", lambda: run_ml20m(dev, trn, args.profile)),
              ("mselect", lambda: run_mselect(dev, trn,
                                              results["ml20m"]["niters"])),
              ("eager", lambda: run_eager(dev, trn)),
              ("fslim", lambda: run_fslim(dev, trn)),
              ("serve", lambda: run_serve(dev)),
              ("admm", lambda: run_admm(dev)),
              ("grid", lambda: run_grid(dev)),
              ("grid_ml20m", lambda: run_grid_ml20m(
                  dev, trn, results["mselect"][0])),
              ("api", lambda: run_api(dev)),
              ("guide", lambda: run_guide(dev, results["ml1m"])),
              ("checkpoint", lambda: run_checkpoint(dev, trn,
                                                    results["ml20m"])),
              ("native", lambda: run_native(dev, trn, native_build_s,
                                            results["ml20m"])))
    if args.only == "dist":
        drives = tuple(d for d in drives if d[0] == "ml20m")
    elif args.only == "native":
        drives = tuple(d for d in drives if d[0] in (
            "synth", "ml1m", "ml20m", "fslim", "native"))
    elif args.only == "cli":
        drives = tuple(d for d in drives if d[0] == "cli")
    by_path = {}

    from slim_tpu_torch.ops.cd_sweep import cd_sweep_large

    def path_launched(path, counts, flushes=None):
        by_path[path] = counts
        shown = dict(counts)
        if counts["cd_sweep_large"] and flushes is not None:
            shown["cd_sweep_large.flush_launches"] = flushes
        print(f"launches {path}:", json.dumps(shown), flush=True)
        missing = [k for k in PATH_KERNELS[path] if counts[k] == 0]
        check(not missing, f"{path} path launched no {missing}: {counts}")
        stray = [k for k, v in counts.items()
                 if v and k not in PATH_KERNELS[path]]
        check(not stray, f"{path} path launched {stray}: {counts}")

    # a path whose references run the API, or the same path again: held to
    # them after its counts
    gates = {"cli": lambda run: check_cli(dev, run),
             "ml20m": lambda run: check_harvest_ml20m(dev, trn, run),
             "grid": lambda run: check_harvest_grid(dev, run),
             "native": lambda run: check_cd_small(dev, run)}
    for path, drive in drives:
        for w in wrappers.values():
            w.launches = 0
        cd_sweep_large.flush_launches = 0
        results[path] = drive()
        path_launched(path, {k: w.launches for k, w in wrappers.items()},
                      cd_sweep_large.flush_launches)
        if path in gates:
            results[path] = gates[path](results[path])
        lap(path)
    if args.only in ("native", "cli"):
        return 0
    for path, (rec, counts) in run_dist(trn, results["ml20m"]).items():
        results[path] = rec
        path_launched(path, counts)
    lap("dist")
    if args.only == "dist":
        return 0

    by_name = {}
    timed = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "share", "library_ms", "shape")
    for c in checks:       # a kernel's first check is at its path's shape
        base = c["name"].split("@")[0]
        e = by_name.get(base)
        if e is None:
            per_path = {p: n[base] for p, n in by_path.items() if n[base]}
            by_name[base] = dict(
                name=base, route=c["route"], source=c["source"],
                replaces=c["replaces"], launches=sum(per_path.values()),
                launches_by_path=per_path, launch_unit=LAUNCH_UNIT[base],
                **{k: c[k] for k in timed if k in c})
        else:
            e["max_abs_err"] = max(e["max_abs_err"], c["max_abs_err"])
            e.setdefault("extra", []).append(
                {k: c[k] for k in timed if k in c})
    print("wall:", json.dumps(dict(walls, total=time.perf_counter() - t_run)))
    print(card_line())
    print(json.dumps({"kernels": list(by_name.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    adopt_orphans()
    try:
        code = main()
    finally:
        stop_children()
    sys.exit(code)
