from lyssandra_tpu_torch.solvers.greedy import GreedyResult, batch_omp, omp

__all__ = ["GreedyResult", "batch_omp", "omp"]
