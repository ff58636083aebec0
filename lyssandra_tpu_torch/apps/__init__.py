from lyssandra_tpu_torch.apps.denoise import Denoiser, denoise, psnr
from lyssandra_tpu_torch.apps.inpaint import inpaint

__all__ = ["Denoiser", "denoise", "inpaint", "psnr"]
