"""Mesh helpers and the data x model EM step on torch.distributed."""

from aaltoasr_tpu_torch.parallel.mesh import (
    make_mesh, sharded_train_step, replicate)

__all__ = ["make_mesh", "sharded_train_step", "replicate"]
