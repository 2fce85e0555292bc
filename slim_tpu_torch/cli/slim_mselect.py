"""slim_mselect: hyper-parameter sweep with warm starting.

CLI parity with src/programs/slim_mselect.c: positionals
``train-file test-file l12-file`` where the l12-file holds whitespace
``l1 l2`` pairs, one per line; each point's model is written to
``<l1> <l2>.model`` (slim_mselect.c:110-112) and the best pair by overall
HR is reported (slim_mselect.c:197-211).
"""

from __future__ import annotations

import sys

from ..config import SlimConfig
from ..io.readers import read_l12file, read_matrix, write_matrix
from ..mselect import mselect_pairs
from .common import add_common_matrix_flags, add_device_flag, banner, \
    errexit_main, make_parser, normalise_argv, setup_logging


def main(argv=None):
    parser = make_parser("slim_mselect", "SLIM model selection sweep.")
    add_common_matrix_flags(parser)
    parser.add_argument("--optTol", type=float, default=1e-7)
    parser.add_argument("--niters", type=int, default=10000)
    parser.add_argument("--nnbrs", type=int, default=0)
    parser.add_argument("--simtype", default="cos",
                        choices=["cos", "jac", "dotp"])
    parser.add_argument("--algo", default="cd", choices=["cd", "admm"])
    parser.add_argument("--nrcmds", type=int, default=10)
    parser.add_argument("--nthreads", type=int, default=0)
    parser.add_argument("--writemodels", action="store_true", default=True,
                        help="write one <l1 l2>.model file per point "
                             "(default on, matching slim_mselect.c:110-112)")
    parser.add_argument("--nowritemodels", dest="writemodels",
                        action="store_false",
                        help="skip the per-point model files")
    add_device_flag(parser)
    parser.add_argument("trnfile")
    parser.add_argument("tstfile")
    parser.add_argument("l12file")
    args = parser.parse_args(normalise_argv(sys.argv[1:] if argv is None
                                            else argv))
    setup_logging(args.dbglvl)
    banner()

    trnmat = read_matrix(args.trnfile, fmt=args.ifmt)
    tstmat = read_matrix(args.tstfile, fmt=args.ifmt)
    pairs = read_l12file(args.l12file)

    if args.binarize:
        trnmat = trnmat.binarize()
        tstmat = tstmat.binarize()

    print(f"  trnfile: {args.trnfile}, nrows: {trnmat.nrows}, "
          f"ncols: {trnmat.ncols}, nnz: {trnmat.nnz}")
    print(f"  tstfile: {args.tstfile}, nrows: {tstmat.nrows}, "
          f"ncols: {tstmat.ncols}, nnz: {tstmat.nnz}")
    print(f"  optTol: {args.optTol:.2e}, niters: {args.niters}")
    print(f"  simtype: {args.simtype}, points: {len(pairs)}")
    print("\nEstimating & evaluating models...\n")

    cfg = SlimConfig(
        optTol=args.optTol, maxniters=args.niters, nnbrs=args.nnbrs,
        simtype=args.simtype, algo=args.algo, nrcmds=args.nrcmds,
        dbglvl=args.dbglvl, nthreads=args.nthreads)

    cb = None
    if args.writemodels:
        def cb(rec, model):
            write_matrix(model, f"{rec['l1r']} {rec['l2r']}.model",
                         fmt=args.ifmt if args.ifmt != "csrnv" else "csr")

    res = mselect_pairs(trnmat, tstmat, cfg, pairs, point_callback=cb,
                        device=args.device)
    for rec in res["results"]:
        print(f"l1r: {rec['l1r']:.2e} l2r: {rec['l2r']:.2e} "
              f"nnz: {rec['nnz']:7d} hr: {rec['hr']:.4f} "
              f"hr_head: {rec['hr_head']:.4f} hr_tail: {rec['hr_tail']:.4f} "
              f"arhr: {rec['arhr']:.4f} time: {rec['time']:.2f}")
    print("\nDone.")
    print("-" * 66)
    print(f"The selected hyperparameters are l1r: {res['bestl1HR']:.2f} "
          f"l2r: {res['bestl2HR']:.2f}")
    print("-" * 66)
    return 0


if __name__ == "__main__":
    sys.exit(errexit_main(main)())
