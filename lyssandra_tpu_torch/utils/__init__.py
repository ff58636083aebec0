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
from lyssandra_tpu_torch.utils.profiling import (
    clear_spans,
    dropped_spans,
    profile_trace,
    span,
    spanned,
    spans,
    timed,
)
from lyssandra_tpu_torch.utils.workspace import Workspace

__all__ = ["Workspace", "cache_enabled", "clear_spans", "dropped_spans",
           "enable_compile_cache", "load_image", "load_image_folders",
           "patch_dataset", "profile_trace", "span", "spanned", "spans",
           "standard_test_image", "synthetic_color_image", "synthetic_image",
           "timed"]
