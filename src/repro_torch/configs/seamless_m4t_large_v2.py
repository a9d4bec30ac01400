"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal [arXiv:2308.11596; hf].

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206.  The transformer
BACKBONE only; the audio frontend is a stub — ``input_specs()`` provides
precomputed frame embeddings (spec requirement).  24 encoder + 24 decoder
layers from the shared layer config.  Pure full attention → long_500k cell
skipped (DESIGN.md §4).

Copied from ``repro.configs.seamless_m4t_large_v2``.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206,
    enc_dec=True, frontend="audio",
    microbatches=16,   # 256k vocab: keep the f32 logits buffer per-mb small
)

SMOKE_CONFIG = CONFIG.reduced(n_kv_heads=4)
