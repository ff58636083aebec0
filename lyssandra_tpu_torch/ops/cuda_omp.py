"""Fused OMP: all pursuit steps of each signal in one kernel
(``lyssandra_tpu.ops.pallas_omp`` counterpart).

``omp_fused`` launches the CUDA kernel ``csrc/omp_fused.cu`` — fixed-T
mode or error-stopped mode with per-lane early exit — for tensors on the
GPU, and runs its plain PyTorch version, ``omp_fused_reference``, for
tensors on the CPU.  Outputs follow ``GreedyResult``: idx (N, T) int32,
gamma (N, T), err (N,) = the final ||r||^2 of the explicit residual, and
nsel (N,) int32; entries past nsel are zero.

The kernel runs OMP in the Gram form: before it, each call builds
G = D^T D with the product kernel (``cuda_gram.gram``, symmetric, one more
launch counted there) and D^T; a block of lanes computes its alpha0 = D^T x
in shared memory, and each step reads the support's rows of G.  The plain
version stays on the residual form, so the two round differently.

alpha0 in shared memory caps K (``kernel_supports``).  Above the cap,
``omp_residual_fused`` runs the same pursuit in the residual form: per
step, the float32 selection kernel of ``csrc/select.cu`` on the lanes still
running, then the update kernel of ``csrc/omp_residual.cu``; no state grows
with K.  Its plain version is ``omp_fused_reference`` too.
"""

from __future__ import annotations

import functools

import torch

from lyssandra_tpu_torch import _build
from lyssandra_tpu_torch.ops import cuda_select
from lyssandra_tpu_torch.ops.cuda_gram import gram
from lyssandra_tpu_torch.solvers.greedy import _omp_impl

_LANES = (16, 8, 4)     # lanes (warps) a block may carry, most first
_NARROW_K = 256         # K at or below which a block carries at most 8
_BP, _STAGE = 8, 2 * 8 * 512   # csrc/omp_fused.cu's slice of p and its
#                                staging ring of D, in floats


def omp_fused_reference(D: torch.Tensor, X: torch.Tensor, *, T: int,
                        eps: float = 0.0, eps_mode: bool = False):
    """Plain version of the kernel: the batched residual-form OMP with the
    same selection tie-break and freeze rules."""
    return tuple(_omp_impl(D, X, eps, T=T, eps_mode=eps_mode))


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def lane_smem_bytes(p: int, K: int, T: int) -> int:
    """Shared memory one lane (warp) of the kernel holds: its column of x
    (p rounded up to the staging slice), alpha0 (K rounded up to 4), the
    T x T factor and six T-vectors."""
    return 4 * (_round_up(p, _BP) + _round_up(K, 4) + T * T + 6 * T)


def block_smem_bytes(p: int, K: int, T: int, lanes: int) -> int:
    """Shared memory a block of ``lanes`` lanes takes: theirs and the
    staging ring of D."""
    return 4 * _STAGE + lanes * lane_smem_bytes(p, K, T)


def block_lanes(p: int, K: int, T: int) -> int:
    """Lanes a block carries: the most of ``_LANES`` whose block fits the
    shared memory a block may have (0: none fits), and at most 8 for
    K <= 256, where smaller blocks ran the denoiser's lanes faster on the
    H100 (PERF.md, section 6)."""
    cap = 8 if K <= _NARROW_K else _LANES[0]
    return next((n for n in _LANES if n <= cap
                 and block_smem_bytes(p, K, T, n) <= _build.SMEM_PER_BLOCK),
                0)


def kernel_supports(p: int, K: int, T: int) -> bool:
    """Whether the kernel takes signals of length p over K atoms at T steps:
    a block of the fewest lanes fits shared memory.  p has no cap of its
    own (it enters the state only as x)."""
    return p >= 1 and K >= 1 and T >= 1 and block_lanes(p, K, T) > 0


def _check_cuda_call(D: torch.Tensor, X: torch.Tensor, T: int, supports,
                     limit: str = "whose block state fits shared memory"
                     ) -> None:
    """Raise unless a kernel takes (D, X) at T steps: both float32 on one
    GPU, D (p, K) and X (p, N), and ``supports(p, K, T)`` (else the error
    names the ``limit``)."""
    if not (X.is_cuda and D.is_cuda and X.device == D.device):
        raise ValueError(
            f"no kernel for D on {D.device} and X on {X.device}")
    if X.dtype != torch.float32 or D.dtype != torch.float32:
        raise ValueError(f"kernel takes float32, got {D.dtype}, {X.dtype}")
    if X.ndim != 2 or D.ndim != 2 or X.shape[0] != D.shape[0]:
        raise ValueError(
            f"D (p, K) and X (p, N) expected, got {tuple(D.shape)} and "
            f"{tuple(X.shape)}")
    p, K = D.shape
    if not supports(p, K, T):
        raise ValueError(
            f"kernel takes a (p, K, T) {limit}; got p={p}, K={K}, T={T}")


def _outputs(N: int, T: int, dev):
    """Zeroed idx and gamma (N, T), err and nsel (N,)."""
    return (torch.zeros((N, T), dtype=torch.int32, device=dev),
            torch.zeros((N, T), dtype=torch.float32, device=dev),
            torch.empty((N,), dtype=torch.float32, device=dev),
            torch.empty((N,), dtype=torch.int32, device=dev))


def omp_fused(D: torch.Tensor, X: torch.Tensor, *, T: int, eps: float = 0.0,
              eps_mode: bool = False):
    """Fused OMP over the columns of X (p, N) with dictionary D (p, K).
    Returns (idx, gamma, err, nsel)."""
    if X.device.type == "cpu" and D.device.type == "cpu":
        return omp_fused_reference(D, X, T=T, eps=eps, eps_mode=eps_mode)
    _check_cuda_call(D, X, T, kernel_supports)
    p, K = D.shape
    N = X.shape[1]
    idx, gamma, err, nsel = _outputs(N, T, X.device)
    if N == 0:
        return idx, gamma, err, nsel
    D = D.contiguous()
    X = X.contiguous()
    G = gram(D, D, symmetric=True)           # (K, K), one launch
    Dt = D.T.contiguous()                    # (K, p): an atom is a row
    lib = _build.load()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lyssa_omp_fused(
            X.data_ptr(), D.data_ptr(), Dt.data_ptr(), G.data_ptr(), p, K, N,
            T, float(eps * eps), int(eps_mode), block_lanes(p, K, T),
            idx.data_ptr(), gamma.data_ptr(), err.data_ptr(),
            nsel.data_ptr(), stream)
    _build.check(lib, code, "omp_fused kernel")
    if eps_mode:
        omp_fused.launches_eps += 1
    else:
        omp_fused.launches_t += 1
    return idx, gamma, err, nsel


# kernel launches, one count per mode: fixed T (K1) and error-stopped (K2)
omp_fused.launches_t = 0
omp_fused.launches_eps = 0


# --- the residual form, for K above the Gram form's cap

_UPDATE_WARPS = 8          # csrc/omp_residual.cu's lanes (warps) a block
_STATE_BYTES = 1 << 28     # device memory a chunk's lane state may take
_SPLIT_BLOCKS = 8          # selection blocks to aim for per SM
_MIN_SPLIT_TILES = 4       # atom tiles a selection block walks at least


def residual_lane_bytes(p: int, T: int) -> int:
    """Device memory one lane's state takes between the residual form's
    launches: x^T and r (p each), Linv (T x T), a0 (T), its two list slots
    and its pick."""
    return 4 * (2 * p + T * T + T + 3)


def residual_chunk_lanes(p: int, T: int) -> int:
    """Lanes the residual form codes at a time: as many as
    ``_STATE_BYTES`` of lane state holds, in whole selection tiles
    (``cuda_select.block_rows(p)`` lanes each); 0 where not one tile fits.
    Lanes are independent, so coding them in chunks is exact."""
    rows = cuda_select.block_rows(p)
    return _STATE_BYTES // residual_lane_bytes(p, T) // rows * rows


def residual_step_smem_bytes(T: int) -> int:
    """Shared memory a block of the step kernel takes: per warp (lane) g,
    w, y, gamma and the support's indices, T each.  Neither p nor K
    enters."""
    return 4 * _UPDATE_WARPS * 5 * T


def residual_splits(p: int, K: int, lanes: int, sms: int) -> tuple[int, int]:
    """(splits, tiles): the selection of ``lanes`` lanes splits its K atoms
    into ``splits`` ranges of ``tiles`` tiles of 128 (the last shorter), one
    block row each, so that it launches about ``_SPLIT_BLOCKS`` blocks an
    SM where its lane tiles alone would be fewer, each block walking at
    least ``_MIN_SPLIT_TILES`` tiles (or all of them)."""
    row_blocks = -(-lanes // cuda_select.block_rows(p))
    nk = -(-K // cuda_select._BN)          # csrc/select.cu's atom tiles
    want = -(-_SPLIT_BLOCKS * sms // row_blocks)
    tiles = -(-nk // max(1, min(want, nk // _MIN_SPLIT_TILES)))
    return -(-nk // tiles), tiles


def residual_kernel_supports(p: int, K: int, T: int) -> bool:
    """Whether the residual form takes signals of length p over K atoms at
    T steps: any K, p within the selection's reach (<= 512), and one
    selection tile of lanes within the state budget."""
    return (1 <= p <= cuda_select.MAX_P and K >= 1 and T >= 1
            and residual_chunk_lanes(p, T) > 0
            and residual_step_smem_bytes(T) <= _build.SMEM_PER_BLOCK)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ptr(t: torch.Tensor, offset: int = 0) -> int:
    """The address of element ``offset`` of a contiguous tensor."""
    return t.data_ptr() + offset * t.element_size()


def omp_residual_fused(D: torch.Tensor, X: torch.Tensor, *, T: int,
                       eps: float = 0.0, eps_mode: bool = False):
    """Fused OMP in the residual form over the columns of X (p, N) with
    dictionary D (p, K), for any K.  Returns (idx, gamma, err, nsel), as
    ``omp_fused`` does.

    On the GPU each chunk of lanes (``residual_chunk_lanes``) is one
    launch of ``csrc/omp_residual.cu``'s init kernel, then per step one
    selection (``csrc/select.cu``'s float32 kernel on the lanes still
    running, the atoms split by ``residual_splits``) and one update
    launch.  The running lanes are listed and counted on the device, so a
    call reads nothing back to the host."""
    if X.device.type == "cpu" and D.device.type == "cpu":
        return omp_fused_reference(D, X, T=T, eps=eps, eps_mode=eps_mode)
    _check_cuda_call(D, X, T, residual_kernel_supports,
                     "with p <= 512 whose lane state fits a chunk of lanes")
    p, K = D.shape
    N = X.shape[1]
    idx, gamma, err, nsel = _outputs(N, T, X.device)
    if N == 0:
        return idx, gamma, err, nsel
    dev = X.device
    D = D.contiguous()
    X = X.contiguous()
    Dt = D.T.contiguous()                    # (K, p): an atom is a row
    cap = min(N, residual_chunk_lanes(p, T))
    splits, tiles = residual_splits(p, K, cap, _sm_count(dev.index or 0))
    f32 = {"dtype": torch.float32, "device": dev}
    i32 = {"dtype": torch.int32, "device": dev}
    xt = torch.empty((cap, p), **f32)
    r = torch.empty((cap, p), **f32)
    L = torch.empty((cap, T, T), **f32)
    a0 = torch.empty((cap, T), **f32)
    lists = torch.empty((2, cap), **i32)
    ksel = torch.empty((splits, cap), **i32)
    bsel = torch.empty((splits, cap), **f32)
    starts = range(0, N, cap)
    counts = torch.zeros((len(starts), T + 1), **i32)
    eps2, mode = float(eps * eps), int(eps_mode)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for n0, cnt in zip(starts, counts):
            _build.check(lib, lib.lyssa_omp_residual_init(
                X.data_ptr(), p, N, n0, min(cap, N - n0), eps2, mode,
                xt.data_ptr(), r.data_ptr(), _ptr(err, n0), _ptr(nsel, n0),
                lists[0].data_ptr(), cnt.data_ptr(), stream),
                "omp_residual init kernel")
            if eps_mode:
                omp_residual_fused.launches_eps += 1
            else:
                omp_residual_fused.launches_t += 1
            for t in range(T):
                rows, nxt = lists[t % 2], lists[(t + 1) % 2]
                _build.check(lib, lib.lyssa_select_rows(
                    r.data_ptr(), rows.data_ptr(), _ptr(cnt, t),
                    D.data_ptr(), p, K, cap, splits, tiles, ksel.data_ptr(),
                    bsel.data_ptr(), stream), "omp_residual selection kernel")
                omp_residual_fused.launches_select += 1
                last = t + 1 == T
                _build.check(lib, lib.lyssa_omp_residual_step(
                    Dt.data_ptr(), xt.data_ptr(), r.data_ptr(), L.data_ptr(),
                    a0.data_ptr(), ksel.data_ptr(), bsel.data_ptr(), splits,
                    rows.data_ptr(), _ptr(cnt, t),
                    None if last else nxt.data_ptr(),
                    None if last else _ptr(cnt, t + 1), p, cap, T, t, eps2,
                    mode, _ptr(idx, n0 * T), _ptr(gamma, n0 * T),
                    _ptr(err, n0), _ptr(nsel, n0), stream),
                    "omp_residual step kernel")
                omp_residual_fused.launches_update += 1
    return idx, gamma, err, nsel


# kernel launches: the init kernel's, one a chunk, by mode (fixed T, K1-L;
# error-stopped, K2-L), and the selection's and the step kernel's, T a
# chunk each, in both modes
omp_residual_fused.launches_t = 0
omp_residual_fused.launches_eps = 0
omp_residual_fused.launches_select = 0
omp_residual_fused.launches_update = 0
