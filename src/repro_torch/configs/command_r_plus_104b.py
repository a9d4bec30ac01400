"""command-r-plus-104b [dense] — GQA, no-bias
[hf:CohereForAI/c4ai-command-r-v01; unverified].

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.  Pure full
attention → long_500k cell skipped (DESIGN.md §4).

Copied from ``repro.configs.command_r_plus_104b``.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab=256000, head_dim=128,
    microbatches=16,
)

SMOKE_CONFIG = CONFIG.reduced(n_kv_heads=2)
