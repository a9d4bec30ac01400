"""tinyllama-1.1b [dense] — llama2-arch small [arXiv:2401.02385; hf].

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.  Copied from
``repro.configs.tinyllama_1_1b``.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab=32000, head_dim=64,
    tie_embeddings=False,
    microbatches=4,
)

SMOKE_CONFIG = CONFIG.reduced(tie_embeddings=True)
