"""Fused group OMP: all T group-selection steps of each signal in one
kernel (``lyssandra_tpu.ops.pallas_group`` counterpart, both of its
kernels: ``_kernel`` and the sublane-packed ``_kernel_packed`` compute the
same thing and differ only in their TPU layout).

``group_omp_fused`` launches the CUDA kernel ``csrc/group_omp.cu`` (in the
Gram form, after ``csrc/gram.cu``'s alpha0 = X^T Dp and Gp = Dp^T Dp over
the slot dictionary Dp) for tensors on the GPU and runs its plain PyTorch
version, ``group_omp_fused_reference``, for tensors on the CPU.  Both take the
atoms permuted into contiguous groups of gs slots (``slot_dictionary``),
padded with zero atoms, and map (group, slot) back to the original atom
ids.  Outputs: idx (N, T*gs) int32 original atom ids, gamma (N, T*gs),
err (N,) = ||r||^2 of the final residual, nsel (N,) int32 = groups
selected, gidx (N, T) int32 group ids.

The kernel's semantics differ from the scan solver
(``solvers.greedy._group_omp_impl``) the way the reference's do:
- no ridge retry: jitter 1e-9, and the lane freezes when a pivot of the
  gs x gs block factor is <= 1e-8;
- a member slot is valid when ||d||^2 > 1e-12, so padded members and a
  genuinely zero atom both get an identity row and gamma 0;
- rows of a frozen step are zero and its group id is 0;
- after T steps a final solve over all slots with two refinement rounds
  gives gamma, and err is that final residual's energy;
- nsel counts groups, not atom slots.
"""

from __future__ import annotations

import numpy as np
import torch

from lyssandra_tpu_torch import _build
from lyssandra_tpu_torch.ops import _launch
from lyssandra_tpu_torch.ops.cuda_gram import gram
from lyssandra_tpu_torch.solvers.greedy import (
    _argmax_first,
    _chol_small_inv,
    _refined_solve,
)

MAX_P = 512
MAX_GS = 8
MAX_SLOTS = 32          # T * gs: one warp thread per slot
_MAX_WARPS = 4          # lanes (warps) per block


def groups_numpy(groups) -> np.ndarray:
    """(K,) int64 group ids from a numpy array, a list or a tensor."""
    if isinstance(groups, torch.Tensor):
        groups = groups.cpu().numpy()
    return np.asarray(groups, np.int64)


def slot_table(groups):
    """(members (ng, gs) int64 atom ids, 0 in padded slots; valid (ng, gs)
    bool; ng; gs) for group ids ``groups``: ng = max id + 1, gs = the
    largest group, members of a group in atom order."""
    g = groups_numpy(groups)
    ng = int(g.max()) + 1
    counts = np.bincount(g, minlength=ng)
    gs = int(counts.max())
    order = np.argsort(g, kind="stable")
    pos = np.arange(len(g)) - np.repeat(np.cumsum(counts) - counts, counts)
    members = np.zeros((ng, gs), np.int64)
    valid = np.zeros((ng, gs), bool)
    members[g[order], pos] = order
    valid[g[order], pos] = True
    return members, valid, ng, gs


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A small host table on ``device``.  The copy is non-blocking: from
    pageable memory it is staged on the host at once and, unlike a
    blocking copy, does not wait for the kernels already queued."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device,
                                                        non_blocking=True)


def slot_dictionary(D: torch.Tensor, members, valid) -> torch.Tensor:
    """(p, ng*gs) contiguous slot dictionary: column g*gs + s is atom
    members[g, s] of D, or zeros in a padded slot.  Gathered on D's
    device; the atoms never visit the host."""
    cols = _upload(members.reshape(-1), D.device)
    keep = _upload(valid.reshape(-1), D.device).to(D.dtype)
    return (D[:, cols] * keep[None, :]).contiguous()


def _atom_ids(members, gidx: torch.Tensor) -> torch.Tensor:
    """(N, T*gs) original atom ids of the slots of group ids gidx (N, T):
    padded members and frozen steps read the table's ids (gamma is 0
    there), as the reference does."""
    table = _upload(members.astype(np.int32), gidx.device)
    ng = table.shape[0]
    N = gidx.shape[0]
    return table[gidx.long().clamp(0, ng - 1)].reshape(N, -1)


def _fused_plain(Dp: torch.Tensor, X: torch.Tensor, ng: int, gs: int,
                 T: int):
    """The kernel's arithmetic on the slot dictionary Dp (p, ng*gs),
    batched over lanes.  Returns (gamma (N, A), gidx (N, T), err, nsel)."""
    p, N = X.shape
    A = T * gs
    dev, dt = X.device, X.dtype
    Xt = X.T
    Dt3 = Dp.T.reshape(ng, gs, p)
    eye = torch.eye(gs, dtype=dt, device=dev)
    rows = torch.arange(N, device=dev)
    r = Xt
    err = (Xt * Xt).sum(dim=1)
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    nsel = torch.zeros((N,), dtype=torch.int32, device=dev)
    gsel = torch.zeros((N, ng), dtype=torch.bool, device=dev)
    L = torch.zeros((N, A, A), dtype=dt, device=dev)
    a0 = torch.zeros((N, A), dtype=dt, device=dev)
    dsel = torch.zeros((N, A, p), dtype=dt, device=dev)
    valid = torch.zeros((N, A), dtype=dt, device=dev)
    gidx = torch.zeros((N, T), dtype=torch.int32, device=dev)
    for t in range(T):
        stop = done
        corr = r @ Dp
        score = (corr * corr).reshape(N, ng, gs).sum(dim=2)
        g = _argmax_first(score - 1e30 * gsel.to(dt)).long()
        gsel[rows, g] |= ~stop
        dnew = Dt3[g]                                         # (N, gs, p)
        vnew = ((dnew * dnew).sum(dim=2) > 1e-12).to(dt)
        W = L @ torch.einsum("nap,ngp->nag", dsel, dnew)      # (N, A, gs)
        Schur = (dnew @ dnew.transpose(1, 2)
                 + eye * (1.0 - vnew)[:, :, None]
                 - W.transpose(1, 2) @ W)
        Lbinv, ok = _chol_small_inv(Schur, gs, 1e-9, pivot_min=1e-8,
                                    floor=1e-12)
        frozen = stop | ~ok
        sl = slice(t * gs, (t + 1) * gs)
        newrows = -(Lbinv @ W.transpose(1, 2) @ L)            # (N, gs, A)
        newrows[:, :, sl] = Lbinv
        fz = frozen[:, None]
        L[:, sl] = torch.where(fz[..., None], 0.0, newrows)
        dsel[:, sl] = torch.where(fz[..., None], 0.0, dnew)
        a0[:, sl] = torch.where(fz, 0.0,
                                torch.einsum("ngp,np->ng", dnew, Xt))
        valid[:, sl] = torch.where(fz, 0.0, vnew)
        gidx[:, t] = torch.where(frozen, gidx[:, t], g.to(torch.int32))
        _, r_new = _refined_solve(L, a0, dsel, Xt)
        r = torch.where(fz, r, r_new)
        err = torch.where(frozen, err, (r_new * r_new).sum(dim=1))
        nsel = torch.where(frozen, nsel, nsel + 1)
        done = frozen
    # rows past a lane's last good step are zero, so this final solve
    # reproduces its retained solution
    gamma, r_f = _refined_solve(L, a0, dsel, Xt)
    return gamma * valid, gidx, (r_f * r_f).sum(dim=1), nsel


def _check_T(T: int, ng: int) -> None:
    if not 1 <= T <= ng:
        raise ValueError(
            f"fused group OMP takes 1 <= T <= n_groups ({ng}), got T={T}; "
            "group_omp clamps T to the number of groups")


def group_omp_fused_reference(D: torch.Tensor, X: torch.Tensor, groups,
                              T: int):
    """Plain version of the kernel: (idx, gamma, err, nsel, gidx)."""
    members, valid, ng, gs = slot_table(groups)
    _check_T(T, ng)
    Dp = slot_dictionary(D, members, valid)
    gamma, gidx, err, nsel = _fused_plain(Dp, X, ng, gs, T)
    return _atom_ids(members, gidx), gamma, err, nsel, gidx


def lane_smem_bytes(p: int, gs: int, T: int) -> int:
    """Shared memory one lane (warp) of the kernel holds (the formula of
    ``lane_floats`` in csrc/group_omp.cu): x and r, the A = T*gs selected
    atoms (rows padded to an odd stride), the A x A factor (odd stride),
    five A-vectors, the cross products and W (A x (gs|1) each), the
    gs x gs block and its inverse, V (gs x A), T group ids and a flag."""
    A = T * gs
    return 4 * (2 * p + A * (p | 1) + A * (A | 1) + 5 * A
                + 2 * A * (gs | 1) + 2 * gs * gs + gs * A + T + 1)


def kernel_supports(p: int, gs: int, T: int) -> bool:
    """Whether the kernel takes signals of length p, groups of gs atoms and
    T steps (T*gs slots, one per thread of a warp)."""
    return (1 <= p <= MAX_P and 1 <= gs <= MAX_GS and T >= 1
            and T * gs <= MAX_SLOTS
            and lane_smem_bytes(p, gs, T) <= _build.SMEM_PER_BLOCK)


def takes(D, X, gs: int, T: int) -> bool:
    """Whether ``group_omp_fused`` launches its kernel for (D, X) with groups
    of at most gs atoms at T steps (T <= n_groups, as ``group_omp`` clamps
    it): a float32 pair on the GPU whose (p, gs, T) the kernel supports."""
    return _launch.kernel_pair(D, X) and kernel_supports(D.shape[0], gs, T)


def group_omp_fused(D: torch.Tensor, X: torch.Tensor, groups, T: int):
    """Fused group OMP over the columns of X (p, N) with dictionary D
    (p, K) and group ids ``groups`` (K,).  Returns (idx, gamma, err, nsel,
    gidx)."""
    if X.device.type == "cpu" and D.device.type == "cpu":
        return group_omp_fused_reference(D, X, groups, T)
    members, valid, ng, gs = slot_table(groups)
    _check_T(T, ng)
    _launch.check_pair(
        D, X, takes,
        f"p <= {MAX_P}, gs <= {MAX_GS} and T*gs <= {MAX_SLOTS}", gs=gs, T=T)
    p = D.shape[0]
    N = X.shape[1]
    dev = X.device
    gamma = torch.zeros((N, T * gs), dtype=torch.float32, device=dev)
    gidx = torch.zeros((N, T), dtype=torch.int32, device=dev)
    err = torch.empty((N,), dtype=torch.float32, device=dev)
    nsel = torch.empty((N,), dtype=torch.int32, device=dev)
    if N == 0:
        return _atom_ids(members, gidx), gamma, err, nsel, gidx
    Dp = slot_dictionary(D, members, valid)
    X = X.contiguous()
    A0 = gram(X, Dp)                    # (N, ng*gs) alpha0 = X^T Dp
    Gp = gram(Dp, Dp, symmetric=True)   # (ng*gs, ng*gs)
    warps = min(_MAX_WARPS, _build.SMEM_PER_BLOCK // lane_smem_bytes(p, gs, T))
    _launch.launch(
        "group_omp_fused", "lyssa_group_omp", X.data_ptr(), Dp.data_ptr(),
        A0.data_ptr(), Gp.data_ptr(), p, ng, gs, N, T, warps,
        gamma.data_ptr(), gidx.data_ptr(), err.data_ptr(), nsel.data_ptr(),
        like=X)
    return _atom_ids(members, gidx), gamma, err, nsel, gidx
