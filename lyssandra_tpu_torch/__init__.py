"""lyssandra_tpu_torch — the PyTorch/CUDA port of lyssandra_tpu.

The JAX package ``lyssandra_tpu`` is the reference; this package keeps its
module names and public layouts (patches are the columns of ``X (p^2, N)``,
a dictionary is ``D (p, K)``, ``GreedyResult`` fields are ``(N, T)``) so
that each piece can be held against its counterpart.  It imports ``torch``
and never ``jax``, nor any ``lyssandra_tpu`` module (importing one runs
``lyssandra_tpu/__init__.py``, which imports ``jax``).

Numerics policy (the counterpart of the reference's
``lax.Precision.HIGHEST``): everything is float32, and float32 matrix
products and convolutions run at full float32 precision — TF32 is off for
both cuBLAS and cuDNN.  It is set once, here, at import.

Every Pallas kernel on the ported path has a hand-written CUDA kernel
(``csrc/``, built by ``_build`` with nvcc and bound with ctypes) and a plain
PyTorch version in the same module.  A wrapper runs the plain version only
for tensors on the CPU; for a CUDA tensor it launches its kernel or raises.

Ported: the patch ops, whitening (``Whitener``) and the DCT dictionary,
the greedy solvers (OMP, Batch-OMP, group OMP, NN-OMP, masked OMP,
thresholding), feature-sign lasso coding, the LARS-lasso homotopy
(``lars``, ``lars_path``), FISTA and LLC, the ``SparseEncoder`` front end
with all those routes, the error-constrained and the adaptive denoiser,
inpainting, feature extraction (``FeatureExtractor``), K-SVD and online
dictionary learning (``KSVDLearner``, ``OnlineDictionaryLearner``), the
classifiers (``LCKSVD``, ``SRCClassifier``, ``LinearClassifier``,
``LinearSVM``), the utilities (``Workspace``, datasets, profiling, the
kernel cache), the experiment runner (``experiments``) and the device mesh
(``parallel``, ``MeshConfig``): a single-controller mesh of device slots,
which several slots of one device or several GPUs fill, taken by every
entry point's ``mesh=``.  Nothing of the reference is left unported.

Entry points run on the GPU unless the caller asks for the CPU, by
``device="cpu"`` or by handing over CPU tensors (``_device.py``).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from lyssandra_tpu_torch import config  # noqa: E402
from lyssandra_tpu_torch.config import (  # noqa: E402
    DenoiseConfig,
    KSVDConfig,
    LassoConfig,
    LCKSVDConfig,
    MeshConfig,
    OMPConfig,
    OnlineDLConfig,
    WhitenConfig,
)
from lyssandra_tpu_torch.ops import (  # noqa: E402
    contrast_normalize,
    dct_dictionary,
    extract_patches,
    init_dictionary,
    launch_counts,
    normalize_atoms,
    reconstruct_from_patches,
    remove_dc,
    reset_launch_counts,
)
from lyssandra_tpu_torch.ops.whitening import (  # noqa: E402
    Whitener,
    ZCAWhitener,
)
from lyssandra_tpu_torch.solvers import (  # noqa: E402
    LarsPath,
    SparseEncoder,
    batch_omp,
    feature_sign,
    feature_sign_scan,
    fista,
    group_omp,
    lars,
    lars_path,
    lasso,
    lasso_lars,
    llc,
    nn_omp,
    omp,
    sparse_encoder,
    threshold_code,
)
from lyssandra_tpu_torch.dict_learning import (  # noqa: E402
    KSVDLearner,
    OnlineDictionaryLearner,
    OnlineDLState,
    ksvd,
    online_dl_step,
)
from lyssandra_tpu_torch.classify import (  # noqa: E402
    LCKSVD,
    LinearClassifier,
    LinearSVM,
    SRCClassifier,
)
from lyssandra_tpu_torch.apps import (  # noqa: E402
    Denoiser,
    FeatureExtractor,
    denoise,
    psnr,
)
from lyssandra_tpu_torch import parallel  # noqa: E402
from lyssandra_tpu_torch.utils import Workspace  # noqa: E402
from lyssandra_tpu_torch.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

__all__ = [
    "DenoiseConfig",
    "Denoiser",
    "FeatureExtractor",
    "KSVDConfig",
    "KSVDLearner",
    "LCKSVD",
    "LCKSVDConfig",
    "LarsPath",
    "LassoConfig",
    "LinearClassifier",
    "LinearSVM",
    "MeshConfig",
    "OMPConfig",
    "OnlineDLConfig",
    "OnlineDLState",
    "OnlineDictionaryLearner",
    "SRCClassifier",
    "SparseEncoder",
    "WhitenConfig",
    "Whitener",
    "Workspace",
    "ZCAWhitener",
    "batch_omp",
    "contrast_normalize",
    "dct_dictionary",
    "denoise",
    "enable_compile_cache",
    "extract_patches",
    "feature_sign",
    "feature_sign_scan",
    "fista",
    "group_omp",
    "init_dictionary",
    "ksvd",
    "lars",
    "lars_path",
    "lasso",
    "lasso_lars",
    "launch_counts",
    "llc",
    "nn_omp",
    "normalize_atoms",
    "omp",
    "online_dl_step",
    "psnr",
    "reconstruct_from_patches",
    "remove_dc",
    "reset_launch_counts",
    "sparse_encoder",
    "threshold_code",
]

__version__ = "0.1.0"
