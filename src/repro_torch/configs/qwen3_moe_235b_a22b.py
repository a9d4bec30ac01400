"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

94L d_model=4096 64H (GQA kv=4) d_ff=1536/expert vocab=151936,
MoE 128e top-8.  Pure full attention → long_500k cell skipped.

Copied from ``repro.configs.qwen3_moe_235b_a22b``.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936, head_dim=128,
    moe_experts=128, moe_top_k=8,
    tie_embeddings=False,
    microbatches=16,
)

SMOKE_CONFIG = CONFIG.reduced(tie_embeddings=True)
