"""Dictionary learning (``lyssandra_tpu.dict_learning`` counterpart).
K-SVD only so far; online dictionary learning is ROADMAP A3."""

from lyssandra_tpu_torch.dict_learning.ksvd import (
    KSVDLearner,
    ksvd,
    ksvd_atom_update,
    ksvd_atom_update_compact,
    ksvd_step,
    ksvd_step_compact,
)

__all__ = [
    "KSVDLearner",
    "ksvd",
    "ksvd_atom_update",
    "ksvd_atom_update_compact",
    "ksvd_step",
    "ksvd_step_compact",
]
