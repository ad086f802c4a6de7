"""xlstm-350m [ssm] -- 24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304
-- sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]

d_ff=0: xLSTM blocks carry their own up/down projections (expand factor 2)
instead of a separate FFN. Every 6th block is an sLSTM block (scalar
memory); the rest are mLSTM (matrix memory, chunkwise-parallel -- the
Pallas kernel target). Recurrent state is O(1) in sequence length, so
long_500k runs.
"""
from .base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2, slstm_every=6),
))
