"""Optimizer and gradient compression (port of ``repro.optim``)."""
from repro_torch.optim.adamw import (AdamW, AdamWState, apply_updates,
                                     global_norm, tree_leaves, tree_map)
from repro_torch.optim.compression import (CompressedAllReduce,
                                           compress_int8, decompress_int8)

__all__ = ["AdamW", "AdamWState", "apply_updates", "global_norm",
           "tree_leaves", "tree_map", "compress_int8", "decompress_int8",
           "CompressedAllReduce"]
