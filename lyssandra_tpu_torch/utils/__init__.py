from lyssandra_tpu_torch.utils.compile_cache import (
    cache_enabled,
    enable_compile_cache,
)
from lyssandra_tpu_torch.utils.datasets import (
    load_image,
    load_image_folders,
    patch_dataset,
    standard_test_image,
    synthetic_color_image,
    synthetic_image,
)
from lyssandra_tpu_torch.utils.profiling import profile_trace, timed
from lyssandra_tpu_torch.utils.workspace import Workspace

__all__ = ["Workspace", "cache_enabled", "enable_compile_cache",
           "load_image", "load_image_folders", "patch_dataset",
           "profile_trace", "standard_test_image", "synthetic_color_image",
           "synthetic_image", "timed"]
