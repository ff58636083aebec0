"""K-SVD's dense atom sweep at one atom a step in one launch
(``dict_learning.ksvd.ksvd_atom_update`` with B=1).

``ksvd_sweep_fused`` launches the CUDA kernel ``csrc/ksvd_sweep.cu`` for
tensors on the GPU and runs the dense sweep ``ksvd._sweep(X, D, Gamma, 1,
n_power)``, the kernel's plain version, for tensors on the CPU.  It
replaces no Pallas kernel: the JAX package runs the sweep as a ``lax``
loop.  The kernel computes what the dense sweep computes, atom by atom and
in order, but over each atom's users alone, with the residual held
transposed (Rt = (X - D Gamma)^T, N x p); its sums run in another order
than the dense products', so the two agree up to rounding.  ``takes`` is
the kernel's envelope: ``ksvd_atom_update`` keeps its own path wherever it
is false.
"""

from __future__ import annotations

import torch

from lyssandra_tpu_torch import _build
from lyssandra_tpu_torch.ops import _launch

CLUSTER = 16               # CTAs the cluster (the non-portable size)
WARPS = 16                 # warps a CTA
P_MAX = 256                # atom rows a warp's lanes hold (8 a lane)
IN_FLIGHT = 3              # code rows and atoms a CTA holds (NB)


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def smem_bytes(p: int, N: int) -> int:
    """Shared memory one CTA of the cluster holds (the formula of
    ``sweep_floats`` in csrc/ksvd_sweep.cu), with L its lanes, Lw =
    ceil(L / WARPS) a warp's and qp = p + 2 padded to 4: 16 bytes of the
    slots' two mbarriers; ``IN_FLIGHT`` buffers of its slice of a code row
    and of an atom; two slots of the cluster's partials, its own sum and
    one partial a warp (qp each); each warp's user lists, (lane, g) for two
    atoms and gt for one."""
    L = _pad4(-(-N // CLUSTER))
    per_warp = -(-L // WARPS)
    qp = _pad4(p + 2)
    return 4 * (4 + IN_FLIGHT * (L + _pad4(p))
                + (2 * CLUSTER + 1 + WARPS) * qp + 5 * WARPS * per_warp)


def takes(X, D, Gamma, B: int, n_power: int) -> bool:
    """Whether ``ksvd_atom_update`` runs its sweep as one launch of the
    kernel: X (p, N), D (p, K) and Gamma (K, N) float32 on one GPU, one
    atom a step (B == 1), n_power >= 1, p <= ``P_MAX``, and the N lanes fit
    the shared memory of the cluster's CTAs."""
    if not (X.is_cuda and D.is_cuda and Gamma.is_cuda
            and X.device == D.device == Gamma.device
            and _launch.kernel_types("cuda", X.dtype, D.dtype, Gamma.dtype)):
        return False
    if not (len(X.shape) == len(D.shape) == len(Gamma.shape) == 2):
        return False
    p, N = X.shape
    K = D.shape[1]
    return (D.shape[0] == p and tuple(Gamma.shape) == (K, N) and B == 1
            and n_power >= 1 and 1 <= p <= P_MAX and K >= 1 and N >= 1
            and smem_bytes(p, N) <= _build.SMEM_PER_BLOCK)


def ksvd_sweep_fused(X: torch.Tensor, D: torch.Tensor, Gamma: torch.Tensor,
                     n_power: int):
    """(D, Gamma) after one B=1 sweep of ``n_power`` power steps an atom,
    in one launch on the GPU, from X (p, N), D (p, K) and dense codes Gamma
    (K, N).  The inputs are not changed; both outputs are new.  The
    residual's transpose is one product before the launch."""
    if not (X.is_cuda or D.is_cuda or Gamma.is_cuda):
        from lyssandra_tpu_torch.dict_learning.ksvd import _sweep

        return _sweep(X, D, Gamma, 1, n_power)
    if not takes(X, D, Gamma, 1, n_power):
        raise ValueError(
            f"kernel takes float32 X (p, N), D (p, K), Gamma (K, N) on one "
            f"GPU, p <= {P_MAX}, n_power >= 1 and lanes that fit the "
            f"cluster's shared memory; got X {tuple(X.shape)} {X.dtype} on "
            f"{X.device}, D {tuple(D.shape)} {D.dtype} on {D.device}, Gamma "
            f"{tuple(Gamma.shape)} {Gamma.dtype} on {Gamma.device}, "
            f"n_power={n_power}")
    p, N = X.shape
    K = D.shape[1]
    D = D.contiguous()
    Gamma = Gamma.contiguous()
    Rt = torch.addmm(X.t(), Gamma.t(), D.t(), alpha=-1.0).contiguous()
    D_out = torch.empty_like(D)
    Gamma_out = torch.empty_like(Gamma)
    _launch.launch("ksvd_sweep", "lyssa_ksvd_sweep", D.data_ptr(),
                   Gamma.data_ptr(), Rt.data_ptr(), D_out.data_ptr(),
                   Gamma_out.data_ptr(), p, K, N, int(n_power), like=D)
    return D_out, Gamma_out
