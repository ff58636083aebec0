"""The device mesh (``lyssandra_tpu.parallel`` counterpart): a
single-controller mesh of device slots, data-sharded coding and K-SVD,
and atom-sharded OMP."""

from lyssandra_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedTensor,
    ksvd_train_step,
    make_mesh,
    replicate,
    shard,
    shard_patches,
    sharded_ksvd_step,
)
from lyssandra_tpu_torch.parallel.model_sharded import omp_model_sharded

__all__ = ["Mesh", "ShardedTensor", "ksvd_train_step", "make_mesh",
           "omp_model_sharded", "replicate", "shard", "shard_patches",
           "sharded_ksvd_step"]
