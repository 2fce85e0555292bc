"""Readings that set the limits of the comparison, on the card:

    python3 benchmark/control.py --workload ml20m.learn --seeds 1,2,3 --seconds 0

For each seed, in one process: the cell's inputs, a short window at the
cell's own load (``--seconds``; 0 runs one unit), and then the compared
numbers twice: for the program's outputs (the lower reading of each limit
comes from a dozen seeds of these) and for the control (the upper
reading), named by the cell's ``limits/<cell>.json`` and found in its
kind's ``CONTROLS`` (``kinds/<kind>.py``):

* ``tf32_step`` (learn): the reference's exact CD update of every
  coordinate taken once from each learned model with G W in TF32, as a
  solver whose products ran in TF32 would leave it;
* ``program_default`` (serve): the program's own lower-precision dense
  route, ``predict_topn(..., precision="default")`` (one bfloat16 pass),
  on the same requests;
* ``tf32_scores`` (serve): the reference's scores with operands rounded
  to TF32, its top-N served in the program's place.

One JSON line per seed; the benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(kind, t, control: str, dev) -> tuple:
    """(the program's numbers, the control's) of the traffic ``t`` after
    its window."""
    prog = kind.judge(t, t.outputs(), dev)
    return prog, kind.judge(t, kind.CONTROLS[control](t, dev), dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    from benchmark import harness, loops

    dev = torch.device(args.device)
    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    kind = bench.kind(mix["kind"])
    ctl = bench.limits(args.workload)["control"]
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        t = kind.Traffic(cfg, mix, seed, dev)
        t.warm()
        t1 = time.perf_counter()
        _, _, units = loops.window(t, args.seconds)
        t2 = time.perf_counter()
        prog, ctrl = readings(kind, t, ctl, dev)
        t3 = time.perf_counter()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "units": len(units), "control": ctl,
                          "program": prog, "control_numbers": ctrl,
                          "s": {"inputs": t1 - t0, "window": t2 - t1,
                                "checks": t3 - t2}}), flush=True)
        t.free()
        del t
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
