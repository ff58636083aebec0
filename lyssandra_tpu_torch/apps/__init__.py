from lyssandra_tpu_torch.apps.denoise import (
    Denoiser,
    denoise,
    denoise_adaptive,
    psnr,
)
from lyssandra_tpu_torch.apps.inpaint import inpaint

__all__ = ["Denoiser", "denoise", "denoise_adaptive", "inpaint", "psnr"]
