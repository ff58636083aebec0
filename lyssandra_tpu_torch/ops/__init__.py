from lyssandra_tpu_torch.ops._launch import launch_counts, reset_launch_counts
from lyssandra_tpu_torch.ops.cuda_fs import fs_cold_fused
from lyssandra_tpu_torch.ops.cuda_fs_scan import fs_scan_fused, fs_scan_seeded
from lyssandra_tpu_torch.ops.cuda_gram import gram
from lyssandra_tpu_torch.ops.cuda_group import group_omp_fused
from lyssandra_tpu_torch.ops.cuda_ksvd_sweep import ksvd_sweep_fused
from lyssandra_tpu_torch.ops.cuda_omp import omp_fused, omp_residual_fused
from lyssandra_tpu_torch.ops.cuda_online_sweep import online_sweep_fused
from lyssandra_tpu_torch.ops.cuda_patches import (
    fused_patch_pipeline,
    fused_patch_pipeline_p1,
)
from lyssandra_tpu_torch.ops.cuda_select import select_abs_argmax
from lyssandra_tpu_torch.ops.dictionaries import (
    dct_dictionary,
    dct_dictionary_color,
    init_dictionary,
    mutual_coherence,
    normalize_atoms,
    replace_unused_atoms,
)
from lyssandra_tpu_torch.ops.patches import (
    contrast_normalize,
    extract_patches,
    fold_patches,
    n_patches,
    reconstruct_from_patches,
    remove_dc,
    weighted_reconstruct,
)

