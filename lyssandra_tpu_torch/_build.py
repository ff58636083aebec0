"""Builds the CUDA kernels in ``csrc/`` and loads them with ctypes.

Every ``csrc/*.cu`` file has a plain C interface (no PyTorch headers, so
nvcc takes seconds, not minutes).  They are compiled together for Hopper
(``sm_90a``) into one shared library under ``_build/``, named by a hash of
the sources and flags, at first use — never at import, so the package and
its CPU tests need neither nvcc nor a GPU.  Each C entry point launches on
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
BUILD_DIR = Path(__file__).parent / "_build"
# dynamic shared memory one block may opt in to on sm_90 (H100, H200)
SMEM_PER_BLOCK = 232448
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every pointer and the stream are c_void_p
_SIGNATURES = {
    # X, D, p, K, N, T, eps2, eps_mode, warps, idx, gamma, err, nsel, stream
    "lyssa_omp_fused": [_P, _P, _I, _I, _I, _I, _F, _I, _I, _P, _P, _P, _P,
                        _P],
    # img, H, W, p, do_dc, do_norm, eps, Wm, off, X, means, scales, stream
    "lyssa_fused_patches": [_P, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P,
                            _P],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
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


def build(extra_flags: tuple[str, ...] = ()) -> str:
    """Compile all sources into ``library_path()``; return nvcc's stderr
    (where ``-Xptxas -v`` reports registers and shared memory)."""
    out = library_path()
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
           *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)       # atomic: a reader never sees half a library
    return proc.stderr


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
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.lyssa_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
