"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060; hf].

16L d_model=2048 16H (GQA kv=16) d_ff=1024/expert vocab=50304,
MoE 64e top-8.  The paper-representative architecture: expert-load skew is
the direct analogue of vertex-degree skew (DESIGN.md §4).  Pure full
attention → long_500k cell skipped.

Copied from ``repro.configs.olmoe_1b_7b``.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304, head_dim=128,
    moe_experts=64, moe_top_k=8,
    microbatches=8,
)

SMOKE_CONFIG = CONFIG.reduced()
