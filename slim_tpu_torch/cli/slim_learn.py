"""slim_learn: estimate a SLIM model from a ratings file.

CLI parity with src/programs/slim_learn.c + cmdline_learn.c: same flags,
defaults (l1r=l2r=1.0, optTol=1e-7, niters=10000, algo=cd, simtype=cos) and
positional ``train-file [model-file]`` with default model name
``slim.model`` (cmdline_learn.c:260-263).

``--dist replicated|blockwise|sharded_g`` learns across a world of ranks,
one per device: launched by ``torchrun --nproc-per-node N`` (NCCL on the
cards, gloo with ``-device=cpu``), or plainly as a one-rank world.  Rank 0
prints and writes the model.
"""

from __future__ import annotations

import sys
import time

from ..api import learn
from ..config import SlimConfig
from ..io.readers import read_matrix, write_matrix
from .common import add_common_matrix_flags, add_device_flag, banner, \
    errexit_main, make_parser, normalise_argv, setup_logging


def main(argv=None):
    parser = make_parser("slim_learn", "Estimate a SLIM model.")
    add_common_matrix_flags(parser)
    parser.add_argument("--l1r", type=float, default=1.0)
    parser.add_argument("--l2r", type=float, default=1.0)
    parser.add_argument("--optTol", type=float, default=1e-7)
    parser.add_argument("--niters", type=int, default=10000)
    parser.add_argument("--nnbrs", type=int, default=0)
    parser.add_argument("--simtype", default="cos",
                        choices=["cos", "jac", "dotp"])
    parser.add_argument("--algo", default="cd", choices=["cd", "admm"])
    parser.add_argument("--ordered", action="store_true")
    parser.add_argument("--nthreads", type=int, default=0)
    parser.add_argument("--ipmdlfile", default=None,
                        help="model file used to warm-start")
    parser.add_argument("--blocksize", type=int, default=256,
                        help="item columns per device batch")
    parser.add_argument("--dist", default="none",
                        choices=["none", "replicated", "blockwise",
                                 "sharded_g"],
                        help="distributed learn mode, one rank per device "
                             "(run under torchrun)")
    add_device_flag(parser)
    parser.add_argument("trnfile")
    parser.add_argument("mdlfile", nargs="?", default="slim.model")
    args = parser.parse_args(normalise_argv(sys.argv[1:] if argv is None
                                            else argv))
    if args.dist == "none":
        return _learn(args, None, True)
    if args.algo != "cd":
        raise ValueError("--dist learns with CD; -algo=admm runs on one "
                         "device")
    import torch.distributed as dist

    from ..parallel.mesh import make_mesh

    mesh = make_mesh(device=args.device)
    try:
        return _learn(args, mesh, dist.get_rank() == 0)
    finally:
        dist.destroy_process_group()


def _learn(args, mesh, verbose: bool):
    """The learn of ``main``; with ``mesh`` across its ranks.  Only a
    ``verbose`` rank prints and writes the model."""
    say = print if verbose else (lambda *a, **k: None)
    if verbose:
        setup_logging(args.dbglvl)
        banner()

    tmat = read_matrix(args.trnfile, fmt=args.ifmt)
    say(f"  trnfile: {args.trnfile}, nrows: {tmat.nrows}, "
        f"ncols: {tmat.ncols}, nnz: {tmat.nnz}")
    say(f"  l1r: {args.l1r:.2e}, l2r: {args.l2r:.2e}, "
        f"binarize: {'Yes' if args.binarize else 'No'}")
    say(f"  solver: {args.algo}, optTol: {args.optTol:.2e}, "
        f"niters: {args.niters}")
    say(f"  mdlfile: {args.mdlfile}")
    say(f"  simtype: {args.simtype}, nnbrs: {args.nnbrs}")
    say("\nEstimating model...")

    if args.binarize:
        tmat = tmat.binarize()

    mfmt = args.ifmt if args.ifmt != "csrnv" else "csr"   # as written below
    imodel = None
    if args.ipmdlfile:
        # read in the format slim_learn writes models in (the JAX package
        # reads csr whatever -ifmt says); an ijv file may omit trailing
        # empty rows, so the model must fit the items, not match them
        imodel = read_matrix(args.ipmdlfile, fmt=mfmt)
        ncols = tmat.infer_ncols().ncols
        if max(imodel.nrows, imodel.ncols) > ncols:
            raise ValueError(f"warm-start model ({imodel.nrows} x "
                             f"{imodel.ncols}) exceeds the train items "
                             f"({ncols})")

    cfg = SlimConfig(
        l1r=args.l1r, l2r=args.l2r, optTol=args.optTol, maxniters=args.niters,
        nnbrs=args.nnbrs, simtype=args.simtype, algo=args.algo,
        ordered=int(args.ordered), dbglvl=args.dbglvl,
        nthreads=args.nthreads, block_size=args.blocksize)
    if mesh is None:
        model, stats = learn(tmat, cfg, imodel=imodel, device=args.device)
    else:
        from ..parallel import dist as D

        fn = {"replicated": D.distributed_learn,
              "blockwise": D.distributed_learn_blockwise,
              "sharded_g": D.distributed_learn_sharded_g}[args.dist]
        t0 = time.perf_counter()
        model, stats = fn(tmat, cfg, mesh, imodel=imodel)
        stats["learn_s"] = time.perf_counter() - t0
        say(f"  dist: {args.dist}, ranks: {stats['ndevices']}")

    if args.mdlfile and verbose:
        write_matrix(model, args.mdlfile, fmt=mfmt)
    say(f"\nmodel nnz: {model.nnz}  loss: {stats.get('loss', 0):.5e}  "
        f"learn: {stats['learn_s']:.2f}s")
    say("\nDone.")
    say("-" * 66)
    return 0


if __name__ == "__main__":
    sys.exit(errexit_main(main)())
