"""internvl2-26b [vlm] — InternViT + InternLM2 [arXiv:2404.16821; hf].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.  The transformer
BACKBONE only; the vision frontend is a stub — ``input_specs()`` provides
precomputed patch embeddings (spec requirement).  Pure full attention →
long_500k cell skipped.

Copied from ``repro.configs.internvl2_26b``.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92553, head_dim=128,
    frontend="vision", frontend_len=256,
    microbatches=16,
)

SMOKE_CONFIG = CONFIG.reduced(n_kv_heads=2)
