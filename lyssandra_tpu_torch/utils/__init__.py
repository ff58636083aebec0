from lyssandra_tpu_torch.utils.datasets import synthetic_image

__all__ = ["synthetic_image"]
