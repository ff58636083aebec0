"""Dictionary learning (``lyssandra_tpu.dict_learning`` counterpart): K-SVD
and online dictionary learning."""

from lyssandra_tpu_torch.dict_learning.ksvd import (
    KSVDLearner,
    ksvd,
    ksvd_atom_update,
    ksvd_atom_update_compact,
    ksvd_step,
    ksvd_step_compact,
)
from lyssandra_tpu_torch.dict_learning.online import (
    OnlineDictionaryLearner,
    OnlineDLState,
    online_dl_step,
)

__all__ = [
    "KSVDLearner",
    "OnlineDLState",
    "OnlineDictionaryLearner",
    "ksvd",
    "ksvd_atom_update",
    "ksvd_atom_update_compact",
    "ksvd_step",
    "ksvd_step_compact",
    "online_dl_step",
]
