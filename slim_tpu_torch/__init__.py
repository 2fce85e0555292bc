"""slim_tpu_torch: the PyTorch / CUDA port of slim_tpu (Sparse LInear
Methods top-N recommendation, Ning & Karypis, ICDM 2011).

Single-device CD (SLIM and FSLIM) and ADMM learning with checkpoint /
resume, warm-started and packed-grid model selection, top-N on dense,
sparse and COO routes, 1-vs-k and candidate scores, HR/ARHR evaluation
and the ``SLIM`` / ``SLIMatrix`` classes, with the JAX package's Pallas
kernels replaced by hand-written Hopper kernels (csrc/).  Imports torch, numpy and scipy,
never jax.

Quick start::

    from slim_tpu_torch import learn, get_topn, SlimConfig
    model, stats = learn(train_csr, SlimConfig(l1r=1.0, l2r=1.0))
    ids, scores, counts = get_topn(model, train_csr, nrcmds=10)
"""

from .config import (SlimConfig, SLIM_OK, SLIM_ERROR, SLIM_DBG_INFO,
                     SLIM_DBG_TIME, SLIM_DBG_PROGRESS)
from .types import CSR
from .api import (SLIM, SLIMatrix, learn, get_topn, read_model, write_model,
                  setup_training_matrix)
from .eval import determine_head_tail, evaluate_topn, EvalResult
from .mselect import mselect_grid, mselect_pairs
from .predict import predict_topn, predict_topn_1vsk
from . import io

__version__ = "0.1.0"

__all__ = [
    "SlimConfig", "CSR", "SLIM", "SLIMatrix", "learn", "get_topn",
    "read_model", "write_model", "setup_training_matrix",
    "determine_head_tail", "evaluate_topn", "EvalResult", "mselect_grid",
    "mselect_pairs", "predict_topn", "predict_topn_1vsk",
    "io", "SLIM_OK", "SLIM_ERROR", "SLIM_DBG_INFO", "SLIM_DBG_TIME",
    "SLIM_DBG_PROGRESS", "__version__",
]
