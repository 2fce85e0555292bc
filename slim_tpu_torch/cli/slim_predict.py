"""slim_predict: top-N prediction + evaluation.

CLI parity with src/programs/slim_predict.c: positionals
``model-file old-file [test-file] [neg-file]``; with a neg-file, all items
are scored, the list is intersected with the pos∪neg candidate set, tie
order among equal scores is randomised, and the list is truncated to
nrcmds (slim_predict.c:110-165).  Prints hr / hr_head / hr_tail / arhr.
"""

from __future__ import annotations

import sys

import numpy as np

from ..eval import determine_head_tail, evaluate_topn
from ..io.readers import read_matrix
from ..predict import predict_candidate_scores, predict_topn
from .common import add_common_matrix_flags, add_device_flag, banner, \
    errexit_main, make_parser, normalise_argv, setup_logging


def negfile_topn(model, oldmat, tstmat, negmat, nrcmds, device):
    """Neg-file mode (slim_predict.c:110-165): each user's candidates are
    pos (test) ∪ neg, deduplicated; a candidate keeps its all-items score
    (history excluded) or 0; equal scores come in a random order (a stable
    sort by score with a random secondary key, ``default_rng(0)``, for the
    reference's double shuffle); the list is truncated to min(nrcmds,
    the user's scored-item count, its candidate count)."""
    nu = oldmat.nrows
    t_ptr = tstmat.indptr if tstmat else np.zeros(nu + 1, np.int64)
    t_ind = tstmat.indices if tstmat else np.zeros(0, np.int32)
    n_ptr, n_ind = negmat.indptr, negmat.indices
    t_cnt, n_cnt = np.diff(t_ptr), np.diff(n_ptr)
    C = max(int((t_cnt + n_cnt).max(initial=1)), 1)
    cand = np.full((nu, C), -1, np.int32)
    rows_t = np.repeat(np.arange(nu), t_cnt)
    cand[rows_t, np.arange(len(t_ind)) - np.repeat(t_ptr[:-1], t_cnt)] = t_ind
    rows_n = np.repeat(np.arange(nu), n_cnt)
    cand[rows_n, t_cnt[rows_n] + np.arange(len(n_ind))
         - np.repeat(n_ptr[:-1], n_cnt)] = n_ind
    # dedup per row: sort descending (-1 padding last), blank repeats
    cand = np.sort(cand, axis=1)[:, ::-1]
    dup = cand[:, 1:] == cand[:, :-1]
    cand[:, 1:][dup] = -1
    ncands = (cand >= 0).sum(axis=1)

    cscores, nscored = predict_candidate_scores(model, oldmat, cand,
                                                device=device)
    rng = np.random.default_rng(0)
    key = np.where(cand >= 0, cscores, -np.inf)
    order = np.lexsort((rng.random(cand.shape), -key), axis=-1)
    ids = np.take_along_axis(cand, order, axis=1)[:, :nrcmds]
    scores = np.take_along_axis(cscores, order, axis=1)[:, :nrcmds]
    counts = np.minimum(np.minimum(nrcmds, nscored), ncands).astype(np.int32)
    ids[np.arange(ids.shape[1])[None, :] >= counts[:, None]] = -1
    if ids.shape[1] < nrcmds:
        pad = nrcmds - ids.shape[1]
        ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        scores = np.pad(scores, ((0, 0), (0, pad)))
    return ids, scores, counts


def main(argv=None):
    parser = make_parser("slim_predict", "Top-N prediction with a SLIM model.")
    add_common_matrix_flags(parser)
    parser.add_argument("--nrcmds", type=int, default=10)
    parser.add_argument("--outfile", default=None)
    add_device_flag(parser)
    parser.add_argument("mdlfile")
    parser.add_argument("trnfile", help="historical (old) ratings")
    parser.add_argument("tstfile", nargs="?", default=None)
    parser.add_argument("negfile", nargs="?", default=None)
    args = parser.parse_args(normalise_argv(sys.argv[1:] if argv is None
                                            else argv))
    setup_logging(args.dbglvl)
    banner()

    model = read_matrix(args.mdlfile, fmt=args.ifmt)
    oldmat = read_matrix(args.trnfile, fmt=args.ifmt)
    tstmat = read_matrix(args.tstfile, fmt=args.ifmt) if args.tstfile else None
    negmat = read_matrix(args.negfile, fmt=args.ifmt) if args.negfile else None

    print(f"  mdlfile: {args.mdlfile}, nrows: {model.nrows}, "
          f"ncols: {model.ncols}, nnz: {model.nnz}")
    print(f"  oldfile: {args.trnfile}, nrows: {oldmat.nrows}, "
          f"ncols: {oldmat.ncols}, nnz: {oldmat.nnz}")
    if tstmat:
        print(f"  tstfile: {args.tstfile}, nrows: {tstmat.nrows}, "
              f"ncols: {tstmat.ncols}, nnz: {tstmat.nnz}")
    print(f"  binarize: {int(args.binarize)}, nrcmds: {args.nrcmds}, "
          f"dbglvl: {args.dbglvl}")
    print("\nMaking predictions...")

    if tstmat and oldmat.nrows != tstmat.nrows:
        raise SystemExit(
            "The number of rows in the old and test files do not match.")

    if args.binarize:
        oldmat = oldmat.binarize()
        if tstmat:
            tstmat = tstmat.binarize()
        if negmat:
            negmat = negmat.binarize()

    if negmat is None:
        ids, scores, counts = predict_topn(model, oldmat, nrcmds=args.nrcmds,
                                           device=args.device)
    else:
        ids, scores, counts = negfile_topn(model, oldmat, tstmat, negmat,
                                           args.nrcmds, args.device)

    if args.outfile:
        with open(args.outfile, "w") as fh:
            for u in range(oldmat.nrows):
                fh.write(" ".join(f" {ids[u, r]} {scores[u, r]:f}"
                                  for r in range(counts[u])))
                fh.write("\n")

    if tstmat is not None:
        ncols = max(oldmat.ncols, tstmat.ncols, model.ncols)
        fmarker = determine_head_tail(oldmat, ncols)
        res = evaluate_topn(ids[:, :args.nrcmds], np.minimum(counts, args.nrcmds),
                            tstmat, fmarker)
        print(f"\nnvalid: {res.nvalid} nvalid_head: {res.nvalid_head} "
              f"nvalid_tail: {res.nvalid_tail}")
        print(f"hr: {res.hr:.4f} hr_head: {res.hr_head:.4f} "
              f"hr_tail: {res.hr_tail:.4f} arhr: {res.arhr:.4f}")
    print("-" * 66)
    return 0


if __name__ == "__main__":
    sys.exit(errexit_main(main)())
