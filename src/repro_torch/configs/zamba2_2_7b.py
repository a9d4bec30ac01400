"""zamba2-2.7b [hybrid] — Mamba2 + shared attn blocks
[arXiv:2411.15242; hf].

54L d_model=2560 32H (kv=32: MHA) d_ff=10240 vocab=32000, ssm_state=64.
54 mamba2 layers with the parameter-shared attention+MLP block applied every
6 layers (9 invocations).  SSM state is O(1) in sequence length → the
long_500k cell RUNS (sub_quadratic=True).  One shared block, no LoRA and no
re-injected embeddings (as the JAX model): 2,340,466,848 parameters, not
the released 2.7 B.

Copied from ``repro.configs.zamba2_2_7b``.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, head_dim=80,
    ssm_state=64, attn_every=6,
    sub_quadratic=True,
    microbatches=8,
)

SMOKE_CONFIG = CONFIG.reduced(n_layers=4, attn_every=2, head_dim=16)
