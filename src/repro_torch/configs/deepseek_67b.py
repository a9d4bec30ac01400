"""deepseek-67b [dense] — llama-arch [arXiv:2401.02954; hf].

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.  Pure full
attention → long_500k cell skipped (DESIGN.md §4).

Copied from ``repro.configs.deepseek_67b``.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=102400, head_dim=128,
    tie_embeddings=False,
    microbatches=16,
)

SMOKE_CONFIG = CONFIG.reduced(n_kv_heads=2, tie_embeddings=True)
