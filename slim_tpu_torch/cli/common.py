"""Shared CLI plumbing for the three slim programs.

Flag names, defaults and the ``-flag=value`` single-dash syntax mirror the
reference GKlib getopt tables (src/programs/cmdline_learn.c:19-33,
cmdline_predict.c, cmdline_mselect.c) so existing scripts port unchanged.
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..config import SLIM_DBG_INFO, SLIM_DBG_TIME


def make_parser(prog: str, description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=prog, description=description, prefix_chars="-",
        allow_abbrev=False)
    return parser


def normalise_argv(argv):
    """Accept the reference's ``-flag=value`` / ``-flag value`` single-dash
    long options by rewriting them to ``--flag``."""
    out = []
    for a in argv:
        if a.startswith("-") and not a.startswith("--") and len(a) > 2 \
                and not a[1].isdigit():
            out.append("-" + a)
        else:
            out.append(a)
    return out


def add_common_matrix_flags(parser):
    parser.add_argument("--ifmt", default="csr",
                        choices=["csr", "csrnv", "cluto", "ijv"],
                        help="input file format [default csr]")
    parser.add_argument("--binarize", action="store_true",
                        help="binarize the ratings")
    parser.add_argument("--dbglvl", type=int,
                        default=SLIM_DBG_INFO | SLIM_DBG_TIME,
                        help="debug level bitmask")


def add_device_flag(parser):
    parser.add_argument("--device", default=None,
                        help="torch device [default: cuda; without a card "
                             "the run stops, so a CPU run passes "
                             "-device=cpu]")


def setup_logging(dbglvl: int):
    logging.basicConfig(level=logging.INFO, format="%(message)s",
                        stream=sys.stdout, force=True)


def banner(version: str = "2.0-torch"):
    line = "-" * 66
    print(line)
    print(f"slim_tpu_torch (SLIM, version {version})")
    print(line)


def errexit_main(main_fn):
    """Wrap a CLI main so user-input errors print one clean line (the
    reference's errexit behaviour) instead of a traceback."""
    def run():
        try:
            return main_fn()
        except FileNotFoundError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        except (ValueError, AssertionError) as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1

    return run
