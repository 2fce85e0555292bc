"""Kind ``serve``: a closed loop of one client sending ``get_topn``
requests for a seeded cycle of user batches (sizes from the mix), each
history a new ``CSR``.  ``"resident": true`` passes the model densified
once in set-up (``predict.densify_model``) as ``W_dev``; else the call is
unpinned and the port's router picks the route.

The comparison holds the kept requests (a seeded sample of the window's
requests, the largest request and the one holding the longest history
among them) to float64 scores (``reference.serve``): ``score_err`` and
``rank_gap`` as shares of each user's best score, and ``invalid_lists``.
The reference works out the dense model and the histories again from the
inputs the benchmark made.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import gen, loops
from benchmark.reference import learn as ref_learn
from benchmark.reference import serve as ref_serve

SAMPLE_REQUESTS = 4   # served requests kept besides the largest


class Traffic:
    KIND, SPAN = "serve", "bench.request"

    def __init__(self, cfg: dict, mix: dict, seed: int, dev):
        from slim_tpu_torch import predict
        from slim_tpu_torch.types import CSR

        self.dev, self.seed = dev, seed
        self.n = cfg["items"]
        self.nrcmds = int(mix["nrcmds"])
        self.indptr, self.indices, pop = loops.ratings(cfg, seed)
        self.model_arrays = gen.serve_model(
            self.n, cfg["serve_model_nnz"], pop, seed, dev)
        self.model = CSR.from_arrays(self.n, self.n, *self.model_arrays)
        self.W = predict.densify_model(self.model, device=dev) \
            if mix["resident"] else None
        self.plan = gen.request_plan(cfg["users"], mix["request_users"],
                                     seed)
        self.hists = [gen.sub_rows(self.indptr, self.indices, u)
                      for u in self.plan]
        self.next = 0
        big = max(range(len(self.plan)), key=lambda i: len(self.plan[i]))
        lens = np.diff(self.indptr)
        longest = max(range(len(self.plan)),
                      key=lambda i: lens[self.plan[i]].max())
        self.always = {big, longest}
        self.last = {}
        self.kept = loops.Reservoir(SAMPLE_REQUESTS, seed)
        self.predict = predict

    def history(self, i: int):
        """Request ``i``'s histories as a new port CSR."""
        from slim_tpu_torch.types import CSR

        indptr, indices = self.hists[i]
        return CSR.from_arrays(len(indptr) - 1, self.n, indptr, indices)

    def _request(self, i: int):
        from slim_tpu_torch import api

        return api.get_topn(self.model, self.history(i), nrcmds=self.nrcmds,
                            W_dev=self.W, device=self.dev)

    def warm(self) -> None:
        """One request of each size the cycle holds."""
        seen = set()
        for i, users in enumerate(self.plan):
            if len(users) not in seen:
                seen.add(len(users))
                self._request(i)
        loops.sync(self.dev)

    def unit(self) -> loops.Unit:
        i = self.next % len(self.plan)
        self.next += 1
        t0 = time.perf_counter()
        out = self._request(i)
        t1 = time.perf_counter()
        if i in self.always:
            self.last[i] = out
        else:
            self.kept.offer((i, out))
        return loops.Unit(t0, t1, len(self.plan[i]),
                          route=self.predict.last_route)

    def outputs(self) -> list:
        """(request index, (ids, scores, counts)) of the kept requests."""
        return sorted(self.kept.items, key=lambda t: t[0]) + \
            sorted(self.last.items())

    def free(self) -> None:
        self.W = None


def judge(t: Traffic, outputs, dev) -> dict:
    """score_err, rank_gap and invalid_lists of ``outputs`` ((request
    index, (ids, scores, counts)) pairs) of ``t``."""
    W = ref_serve.dense_model(*t.model_arrays, t.n, dev)
    err, gap, invalid = 0.0, 0.0, 0
    for i, (ids, scores, counts) in outputs:
        H = ref_serve.dense_history(*t.hists[i], t.n, dev)
        e, g, b = ref_serve.judge(ref_serve.scores(H, W), ids, scores,
                                  counts)
        err, gap, invalid = max(err, e), max(gap, g), invalid + b
    return {"score_err": err, "rank_gap": gap, "invalid_lists": invalid}


def program_default(t: Traffic, dev) -> list:
    """The program's own lower-precision dense route,
    ``predict_topn(..., precision="default")`` (one bfloat16 pass), on the
    kept requests."""
    from slim_tpu_torch.predict import predict_topn

    return [(i, predict_topn(t.model, t.history(i), nrcmds=t.nrcmds,
                             W_dev=t.W, precision="default", device=dev))
            for i, _ in t.outputs()]


def tf32_scores(t: Traffic, dev) -> list:
    """The reference's scores with operands rounded to TF32, its top-N
    served in the program's place, on the kept requests."""
    W = ref_learn.to_tf32(ref_serve.dense_model(
        *t.model_arrays, t.n, dev, dtype=torch.float32))
    outs = []
    for i, _ in t.outputs():
        H = ref_serve.dense_history(*t.hists[i], t.n, dev,
                                    dtype=torch.float32)
        S = (H @ W).masked_fill_(H > 0, float("-inf"))
        outs.append((i, ref_serve.topn(S, t.nrcmds)))
    return outs


CONTROLS = {"program_default": program_default, "tf32_scores": tf32_scores}
