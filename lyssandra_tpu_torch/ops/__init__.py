from lyssandra_tpu_torch.ops.cuda_fs import fs_cold_fused
from lyssandra_tpu_torch.ops.cuda_fs_scan import fs_scan_fused
from lyssandra_tpu_torch.ops.cuda_gram import gram
from lyssandra_tpu_torch.ops.cuda_group import group_omp_fused
from lyssandra_tpu_torch.ops.cuda_omp import omp_fused, omp_residual_fused
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


def launch_counts() -> dict[str, int]:
    """Kernel launches so far in this process, by kernel."""
    return {
        "omp_fused_t": omp_fused.launches_t,
        "omp_fused_eps": omp_fused.launches_eps,
        "omp_residual_t": omp_residual_fused.launches_t,
        "omp_residual_eps": omp_residual_fused.launches_eps,
        "omp_residual_select": omp_residual_fused.launches_select,
        "omp_residual_update": omp_residual_fused.launches_update,
        "fused_patches": fused_patch_pipeline_p1.launches,
        "group_omp_fused": group_omp_fused.launches,
        "fs_cold": fs_cold_fused.launches,
        "fs_scan": fs_scan_fused.launches,
        "select_abs_argmax": select_abs_argmax.launches,
        "gram": gram.launches,
    }


def reset_launch_counts() -> None:
    omp_fused.launches_t = 0
    omp_fused.launches_eps = 0
    omp_residual_fused.launches_t = 0
    omp_residual_fused.launches_eps = 0
    omp_residual_fused.launches_select = 0
    omp_residual_fused.launches_update = 0
    fused_patch_pipeline_p1.launches = 0
    group_omp_fused.launches = 0
    fs_cold_fused.launches = 0
    fs_scan_fused.launches = 0
    select_abs_argmax.launches = 0
    gram.launches = 0
