from lyssandra_tpu_torch.solvers.greedy import (
    GreedyResult,
    batch_omp,
    group_omp,
    omp,
    threshold_code,
)
from lyssandra_tpu_torch.solvers.encoder import SparseEncoder, sparse_encoder

__all__ = ["GreedyResult", "SparseEncoder", "batch_omp", "group_omp", "omp",
           "sparse_encoder", "threshold_code"]
