from lyssandra_tpu_torch.utils.datasets import (
    load_image,
    patch_dataset,
    standard_test_image,
    synthetic_image,
)
from lyssandra_tpu_torch.utils.workspace import Workspace

__all__ = ["Workspace", "load_image", "patch_dataset", "standard_test_image",
           "synthetic_image"]
