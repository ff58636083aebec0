from lyssandra_tpu_torch.apps.denoise import Denoiser, denoise, psnr

__all__ = ["Denoiser", "denoise", "psnr"]
