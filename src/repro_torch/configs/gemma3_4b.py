"""gemma3-4b [dense] — 5:1 local:global, 128k context
[hf:google/gemma-3-1b-pt; unverified].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.  Sliding-window
local layers (1024) with every 6th layer global.  The 5:1 pattern makes the
decode cost dominated by the local window → long_500k cell RUNS
(sub_quadratic=True, DESIGN.md §4).

Copied from ``repro.configs.gemma3_4b``.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
    d_ff=10240, vocab=262144, head_dim=256,
    local_window=1024, local_global_ratio=5,
    rope_theta=1_000_000.0,
    sub_quadratic=True,
    microbatches=8,
)

SMOKE_CONFIG = CONFIG.reduced(local_window=8, local_global_ratio=2,
                              n_layers=6)
