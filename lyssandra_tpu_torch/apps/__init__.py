from lyssandra_tpu_torch.apps.denoise import (
    Denoiser,
    denoise,
    denoise_adaptive,
    psnr,
)
from lyssandra_tpu_torch.apps.features import (
    FeatureExtractor,
    spatial_pyramid_pool,
)
from lyssandra_tpu_torch.apps.inpaint import inpaint

__all__ = ["Denoiser", "FeatureExtractor", "denoise", "denoise_adaptive",
           "inpaint", "psnr", "spatial_pyramid_pool"]
