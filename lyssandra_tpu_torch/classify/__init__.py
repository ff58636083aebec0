"""Classification on sparse codes (``lyssandra_tpu.classify``
counterpart): LC-KSVD, SRC and the linear heads."""

from lyssandra_tpu_torch.classify.lc_ksvd import LCKSVD
from lyssandra_tpu_torch.classify.linear import (
    LinearClassifier,
    LinearSVM,
    one_hot,
    ridge,
)
from lyssandra_tpu_torch.classify.src import SRCClassifier

__all__ = ["LCKSVD", "LinearClassifier", "LinearSVM", "SRCClassifier",
           "one_hot", "ridge"]
