"""Distributed learning and prediction on torch.distributed, one process
per device (port of slim_tpu/parallel/)."""

from .dist import (distributed_learn, distributed_learn_blockwise,
                   distributed_learn_sharded_g, sharded_learn_step,
                   sharded_predict)
from .mesh import default_mesh_shape, init_distributed, make_mesh

__all__ = ["make_mesh", "default_mesh_shape", "init_distributed",
           "sharded_learn_step", "distributed_learn",
           "distributed_learn_blockwise", "distributed_learn_sharded_g",
           "sharded_predict"]
