"""Builds the CUDA kernels in ``csrc/`` and loads them with ctypes.

Every ``csrc/*.cu`` file has a plain C interface (no PyTorch headers, so
nvcc takes seconds, not minutes).  They are compiled for Hopper
(``sm_90a``), one nvcc process per source, all started together, and
linked into one shared library under ``_build/``, named by a hash of the
sources and flags, at first use — never at import, so the package and its
CPU tests need neither nvcc nor a GPU.  Each C entry point launches on
the stream it is given and returns ``cudaGetLastError()``; ``check`` turns
a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
DEFAULT_DIR = Path(__file__).parent / "_build"
# where the library is built and looked up (utils.enable_compile_cache)
BUILD_DIR = DEFAULT_DIR
# dynamic shared memory one block may opt in to on sm_90 (H100, H200)
SMEM_PER_BLOCK = 232448
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every pointer and the stream are c_void_p
_SIGNATURES = {
    # X, D, Dt, G, p, K, N, T, eps2, eps_mode, lanes, idx, gamma, err,
    # nsel, stream
    "lyssa_omp_fused": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P, _P,
                        _P, _P, _P],
    # X, p, N, n0, C, eps2, eps_mode, xt, r, err, nsel, list, cnt, stream
    "lyssa_omp_residual_init": [_P, _I, _I, _I, _I, _F, _I, _P, _P, _P, _P,
                                _P, _P, _P],
    # Dt, xt, r, L, a0, ksel, bsel, splits, list_in, cnt_in, list_out,
    # cnt_out, p, C, T, t, eps2, eps_mode, idx, gamma, err, nsel, stream
    "lyssa_omp_residual_step": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                                _P, _I, _I, _I, _I, _F, _I, _P, _P, _P, _P,
                                _P],
    # X, Dp, A0, Gp, p, ng, gs, N, T, warps, gamma, gidx, err, nsel, stream
    "lyssa_group_omp": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                        _P, _P],
    # img, H, W, p, do_dc, do_norm, eps, Wm, off, X, means, scales, stream
    "lyssa_fused_patches": [_P, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P,
                            _P],
    # A0, G, K, N, tun, n_refine, lam, thr, thr_done, warps, idx, mask,
    # theta, gact, gr, done, stream
    "lyssa_fs_cold": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _P, _P, _P, _P,
                      _P, _P, _P],
    # A0, G, K, N, A, max_iter, max_inner, max_cg, lam, thr, thr_done,
    # gamma, done, overflow, stream
    "lyssa_fs_scan": [_P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P, _P, _P,
                      _P],
    # r, D, p, K, N, bf16, Dh, k_out, stream
    "lyssa_select_abs_argmax": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    # r, rows, count, D, p, K, N, splits, tiles, k_out, best_out, stream
    "lyssa_select_rows": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    # A, B, p, M, K, symmetric, C, stream
    "lyssa_gram": [_P, _P, _I, _I, _I, _I, _P, _P],
    # D, AT, B, Dout, p, K, n_sweeps, cluster, stream
    "lyssa_online_sweep": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # D, Gamma, Rt, Dout, Gout, p, K, N, n_power, stream
    "lyssa_ksvd_sweep": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    """The headers the sources include (``csrc/*.cuh``)."""
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblyssa_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under $CUDA_HOME/bin); "
            "the CUDA kernels can only be built where the CUDA toolkit is")
    return nvcc


def _run(cmd: list[str], proc: subprocess.Popen) -> str:
    """Wait for an nvcc process; raise with its output if it failed, else
    return its stderr."""
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{stdout}{stderr}")
    return stderr


def _start(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def build(extra_flags: tuple[str, ...] = ()) -> str:
    """Compile every source into an object, one nvcc each and all at once,
    then link them into ``library_path()``.  Returns the compilers' stderr
    (where ``-Xptxas -v`` reports registers and shared memory)."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.name}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    tmp = BUILD_DIR / f"{tag}.tmp"
    cmds = [[nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objs)]
    procs = [_start(cmd) for cmd in cmds]
    try:
        logs = [_run(cmd, proc) for cmd, proc in zip(cmds, procs)]
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                *map(str, objs)]
        logs.append(_run(link, _start(link)))
        os.replace(tmp, out)   # atomic: a reader never sees half a library
    finally:
        for proc in procs:     # a failed compile leaves none running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return "".join(logs)


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built first if this source state has none."""
    path = library_path()
    if not path.exists():
        build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.lyssa_error_string.argtypes = [ctypes.c_int]
    lib.lyssa_error_string.restype = ctypes.c_char_p
    lib.lyssa_fused_patches_whiten_smem.argtypes = [ctypes.c_int]
    lib.lyssa_fused_patches_whiten_smem.restype = ctypes.c_size_t
    lib.lyssa_select_smem_bytes.argtypes = [_I, _I, _I]
    lib.lyssa_select_smem_bytes.restype = ctypes.c_size_t
    lib.lyssa_omp_fused_smem_bytes.argtypes = [_I, _I, _I, _I]
    lib.lyssa_omp_fused_smem_bytes.restype = ctypes.c_size_t
    lib.lyssa_omp_residual_step_smem_bytes.argtypes = [_I]
    lib.lyssa_omp_residual_step_smem_bytes.restype = ctypes.c_size_t
    lib.lyssa_fs_scan_smem_bytes.argtypes = [_I]
    lib.lyssa_fs_scan_smem_bytes.restype = ctypes.c_size_t
    lib.lyssa_online_sweep_smem_bytes.argtypes = [_I, _I, _I]
    lib.lyssa_online_sweep_smem_bytes.restype = ctypes.c_size_t
    lib.lyssa_ksvd_sweep_smem_bytes.argtypes = [_I, _I]
    lib.lyssa_ksvd_sweep_smem_bytes.restype = ctypes.c_size_t
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.lyssa_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
