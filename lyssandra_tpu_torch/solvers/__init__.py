from lyssandra_tpu_torch.solvers.greedy import (
    GreedyResult,
    batch_omp,
    group_omp,
    masked_omp,
    nn_omp,
    omp,
    threshold_code,
)
from lyssandra_tpu_torch.solvers.lasso import (
    FeatureSignResult,
    LarsPath,
    feature_sign,
    feature_sign_scan,
    fista,
    lars,
    lars_path,
    lasso,
    lasso_lars,
)
from lyssandra_tpu_torch.solvers.llc import llc
from lyssandra_tpu_torch.solvers.encoder import SparseEncoder, sparse_encoder

__all__ = ["FeatureSignResult", "GreedyResult", "LarsPath", "SparseEncoder",
           "batch_omp", "feature_sign", "feature_sign_scan", "fista",
           "group_omp", "lars", "lars_path", "lasso", "lasso_lars", "llc",
           "masked_omp", "nn_omp", "omp", "sparse_encoder", "threshold_code"]
