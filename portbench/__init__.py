"""The benchmark of lyssandra_tpu_torch, the PyTorch/CUDA port (see
README.md).  Nothing here imports jax or the JAX package."""
