"""slim_predict: top-N prediction + evaluation.

CLI parity with src/programs/slim_predict.c: positionals
``model-file old-file [test-file]``.  Prints hr / hr_head / hr_tail /
arhr.  The neg-file mode (slim_predict.c:110-165) is not ported yet.
"""

from __future__ import annotations

import sys

import numpy as np

from ..eval import determine_head_tail, evaluate_topn
from ..io.readers import read_matrix
from ..predict import predict_topn
from .common import add_common_matrix_flags, add_device_flag, banner, \
    errexit_main, make_parser, normalise_argv, setup_logging


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
    if args.negfile:
        raise NotImplementedError("neg-file mode (candidate scores) is not "
                                  "ported yet")
    setup_logging(args.dbglvl)
    banner()

    model = read_matrix(args.mdlfile, fmt=args.ifmt)
    oldmat = read_matrix(args.trnfile, fmt=args.ifmt)
    tstmat = read_matrix(args.tstfile, fmt=args.ifmt) if args.tstfile else None

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

    ids, scores, counts = predict_topn(model, oldmat, nrcmds=args.nrcmds,
                                       device=args.device)

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
