"""Patch-based image denoising (Elad & Aharon 2006;
``lyssandra_tpu.apps.denoise`` counterpart).

Pipeline (oracle.denoise parity):
  noisy image -> all overlapping p x p patches -> DC removal ->
  error-constrained OMP with eps = gain * p * sigma ->
  patch reconstruction -> overlap-add blend
  (lam*y + sum R^T D gamma) / (lam + counts).

On a GPU the patch pipeline is the fused-patches kernel and the coder's
first phase the error-stopped OMP kernel; on the CPU both are their plain
versions.  With a ``mesh`` (``parallel.Mesh``) the patch pipeline runs on
the first slot and the coder is the blocked error-stopped Batch-OMP of
``SparseEncoder``, each block split over the data slots (the error-stopped
kernel per slot on a GPU).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lyssandra_tpu_torch._device import resolve_device
from lyssandra_tpu_torch.config import DenoiseConfig, KSVDConfig
from lyssandra_tpu_torch.dict_learning.ksvd import KSVDLearner
from lyssandra_tpu_torch.ops.cuda_patches import fused_patch_pipeline
from lyssandra_tpu_torch.ops.patches import (
    extract_patches,
    remove_dc,
    weighted_reconstruct,
)
from lyssandra_tpu_torch.parallel.mesh import mesh_device
from lyssandra_tpu_torch.solvers.encoder import SparseEncoder
from lyssandra_tpu_torch.solvers.greedy import (
    GreedyResult,
    _fused_supported,
    _omp_fused_call,
    _omp_impl,
    batch_omp,
)
from lyssandra_tpu_torch.utils.datasets import patch_dataset
from lyssandra_tpu_torch.utils.profiling import span, spanned


def _eps_two_phase(D, Xc, *, eps, T1, T_max, cap=4096, order="raster"):
    """Two-phase error-constrained coder; returns the dense Gamma (K, N).

    Phase 1: one fused pass in eps mode capped at T1 atoms.
    Phase 2: lanes that used all T1 atoms without reaching eps are
    compacted, ``cap`` at a time, and re-solved from scratch at T_max with
    the batched residual form.  Greedy pursuit is deterministic, so the
    re-solve equals a single pass at T_max on those lanes.  The loop asks
    the device one question per round: how many lanes are left.  Phase 2,
    after the first count, is the span ``lyssa.denoise.phase2``, whose
    ``lanes`` is that count.
    """
    K = D.shape[1]
    N = Xc.shape[1]
    dev = Xc.device
    if order == "energy":
        # difficulty-ordered lanes; the codes are the same in any order
        perm = torch.argsort((Xc * Xc).sum(dim=0), stable=True)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(N, device=dev)
        Xc = Xc[:, perm]
    elif order != "raster":
        raise ValueError(f"order must be raster or energy: {order}")
    res = _omp_fused_call(D, Xc, T=T1, eps=eps, eps_mode=True, dense=False)
    if order == "energy":
        res = GreedyResult(*(f[inv] for f in res))
        Xc = Xc[:, inv]
    # the lanes left as 0/1 int32, so that a count of them is one reduction
    # (a bool mask's sum would first cast it) and each round's question
    # launches no more than asking for any lane would
    bad = torch.logical_and(res.nsel == T1, res.err > eps * eps,
                            out=torch.empty(N, dtype=torch.int32, device=dev))
    # one spare all-zero lane N takes the writes of unused compaction
    # slots (the reference's scatter mode="drop"); padding the compact
    # result, not the dense (K, N) Gamma, avoids copying Gamma
    Gamma = GreedyResult(*(
        torch.cat([f, f.new_zeros((1,) + f.shape[1:])]) for f in res
    )).dense(K)
    slots = torch.arange(cap, device=dev)
    lanes = torch.arange(N, device=dev)
    left = int(bad.sum(dtype=torch.int32))
    with span("lyssa.denoise.phase2", lanes=left):
        while left:
            pos = torch.cumsum(bad, dim=0) - 1           # rank among bad
            sel = torch.logical_and(bad, pos < cap)
            # cols[j] = column of the j-th selected lane; unselected lanes
            # write into the spare slot `cap`, which is dropped
            cols = torch.zeros((cap + 1,), dtype=torch.long, device=dev)
            cols.scatter_(0, torch.where(sel, pos, cap), lanes)
            cols = cols[:cap]
            rs = _omp_impl(D, Xc[:, cols], eps, T=T_max, eps_mode=True)
            colsafe = torch.where(slots < sel.sum(), cols, N)
            Gamma[:, colsafe] = rs.dense(K)
            torch.logical_and(bad, ~sel, out=bad)
            left = int(bad.sum(dtype=torch.int32))
    return Gamma[:, :N]


def _denoise_fused_impl(D, noisy, *, p, eps, T1, T_max, lam_w,
                        order="raster"):
    """The denoise forward: patch pipeline -> two-phase eps coder ->
    reconstruction -> overlap-add blend."""
    if noisy.ndim == 3:
        Xc, means = remove_dc(extract_patches(noisy, p))
    else:
        Xc, means, _ = fused_patch_pipeline(noisy, p, do_dc=True)
    Gamma = _eps_two_phase(D, Xc, eps=eps, T1=T1, T_max=T_max, order=order)
    Xhat = D @ Gamma + means[None, :]
    return weighted_reconstruct(Xhat, noisy, p, lam_w)


class Denoiser:
    """Reference-mirroring denoiser: ``denoise(img) -> img_hat``.

    D: unit-norm dictionary over p x p patches (e.g. DCT or K-SVD-learned),
    moved to ``device`` (default: where D lies if it is a tensor, else the
    GPU; see ``_device.resolve_device``).  Noisy images go to D's device.
    With a ``mesh``, D lies on its first slot and the patches are coded
    over its data slots; a ``device`` other than the first slot's raises.
    Each call is the span ``lyssa.denoise`` (``utils.profiling``).
    """

    def __init__(self, D, cfg: DenoiseConfig = DenoiseConfig(), *,
                 mesh=None, device=None):
        if mesh is not None:
            device = mesh_device(mesh, device)
        device = resolve_device(device, D)
        if not isinstance(D, torch.Tensor):
            D = np.array(D, dtype=np.float32)     # a writable copy
        self.D = torch.as_tensor(D, dtype=torch.float32, device=device)
        self.cfg = cfg
        self.mesh = mesh

    def _fast_path(self) -> bool:
        """True when the two-phase coder applies: T_max leaves headroom
        above the first phase's T1 = min(10, T_max), and that phase's fused
        solve takes D (its plain version for a CPU D; on the GPU the kernel,
        where ``_fused_supported`` finds the shape inside its envelope).
        Elsewhere the blocked Batch-OMP path codes the patches."""
        cfg = self.cfg
        T1 = min(10, cfg.T_max)
        return (self.mesh is None and cfg.T_max > T1
                and (not self.D.is_cuda or _fused_supported(self.D, self.D,
                                                            T1)))

    @spanned("lyssa.denoise")
    def __call__(self, noisy, sigma: float | None = None) -> torch.Tensor:
        cfg = self.cfg
        sigma = float(cfg.sigma if sigma is None else sigma)
        p = cfg.patch
        noisy = torch.as_tensor(noisy, dtype=torch.float32,
                                device=self.D.device)
        dim = p * p * (noisy.shape[2] if noisy.ndim == 3 else 1)
        eps = cfg.gain * math.sqrt(dim) * sigma
        lam_w = cfg.lam / max(sigma, 1e-12)
        if self._fast_path():
            return _denoise_fused_impl(
                self.D, noisy, p=p, eps=float(eps), T1=min(10, cfg.T_max),
                T_max=cfg.T_max, lam_w=float(lam_w), order=cfg.order)
        if noisy.ndim == 3:
            Xc, means = remove_dc(extract_patches(noisy, p))
        else:
            Xc, means, _ = fused_patch_pipeline(noisy, p, do_dc=True)
        if self.mesh is not None:
            Gamma = SparseEncoder(
                "bomp", {"T": cfg.T_max, "eps": eps}, block=cfg.block,
                mesh=self.mesh, check_atoms=False).encode(Xc, self.D)
        else:
            Gamma = torch.cat([
                batch_omp(self.D, Xc[:, i:i + cfg.block], cfg.T_max, eps=eps)
                for i in range(0, Xc.shape[1], cfg.block)
            ], dim=1)
        Xhat = self.D @ Gamma + means[None, :]
        return weighted_reconstruct(Xhat, noisy, p, lam_w)


def denoise(noisy, D, sigma: float, *, cfg: DenoiseConfig | None = None,
            mesh=None, device=None) -> torch.Tensor:
    """Functional entry point (oracle.denoise parity)."""
    cfg = cfg or DenoiseConfig()
    return Denoiser(D, cfg, mesh=mesh, device=device)(noisy, sigma)


@spanned("lyssa.denoise_adaptive")
def denoise_adaptive(noisy, sigma: float, *, cfg: DenoiseConfig | None = None,
                     K: int = 256, n_iter: int = 12, n_train: int = 30000,
                     mesh=None, return_dictionary: bool = False,
                     device=None):
    """The adaptive Elad-Aharon pipeline: train a K-SVD dictionary (DCT
    start) on ``n_train`` patches of the noisy image itself with the same
    error-stopped coder, then denoise with it.  Runs on ``device``
    (default: where ``noisy`` lies if it is a tensor, else the GPU), or
    with a ``mesh`` over its slots: the mesh goes to the encoder, the
    learner and the denoiser.  Returns the image, and with
    ``return_dictionary`` also D.  The call is the span
    ``lyssa.denoise_adaptive`` (``utils.profiling``); its self time is the
    host copy of the image, the patch sample and the builds."""
    if mesh is not None:
        device = mesh_device(mesh, device)
    device = resolve_device(device, noisy)
    cfg = cfg or DenoiseConfig(sigma=sigma)
    noisy_np = (noisy.detach().cpu().numpy() if isinstance(noisy, torch.Tensor)
                else np.asarray(noisy)).astype(np.float64)
    dim = cfg.patch * cfg.patch * (
        noisy_np.shape[2] if noisy_np.ndim == 3 else 1)
    eps = cfg.gain * math.sqrt(dim) * float(sigma)
    train = patch_dataset([noisy_np], p=cfg.patch, n_patches=n_train,
                          seed=3).astype(np.float32)
    enc = SparseEncoder("bomp", {"T": cfg.T_max, "eps": eps},
                        check_atoms=False, mesh=mesh, device=device)
    learner = KSVDLearner(
        KSVDConfig(K=K, T=cfg.T_max, n_iter=n_iter, init="dct"),
        encoder=enc, mesh=mesh, device=device).fit(train)
    out = Denoiser(learner.D_, cfg, mesh=mesh, device=device)(noisy, sigma)
    return (out, learner.D_) if return_dictionary else out


def psnr(a, b, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB, computed in float32."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    mse = torch.mean((a - b) ** 2)
    return float(10.0 * torch.log10(peak * peak / mse))
