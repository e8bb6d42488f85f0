from .adamw import (AdamWConfig, adamw_init, adamw_update, clip_by_global_norm,
                    clip_scale, cosine_schedule, global_norm,
                    global_norm_leaves, leaf_update, step_factors,
                    tree_leaves)
from .compress import (BLOCK, compress_int8, compressed_allreduce,
                       decompress_int8)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "global_norm_leaves", "clip_scale",
           "clip_by_global_norm", "leaf_update", "step_factors",
           "tree_leaves", "BLOCK", "compress_int8", "decompress_int8",
           "compressed_allreduce"]
