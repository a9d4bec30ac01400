"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12L d_model=768 4H d_ff=0 vocab=50304.  d_ff=0: the blocks are pure mixers
with internal projection factor 2 (xLSTM paper).  Every 4th layer is sLSTM
(sequential scalar memory), the rest mLSTM (chunk-parallel matrix memory via
the SSD dual).  Recurrent state is O(1) in sequence length → the long_500k
cell RUNS (sub_quadratic=True).  123,725,664 parameters.

Copied from ``repro.configs.xlstm_125m``.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    slstm_every=4,
    sub_quadratic=True,
    microbatches=8,    # 50k vocab at B=256: logits dominate temp below 8 mb
)

SMOKE_CONFIG = CONFIG.reduced(d_ff=0)
