"""seamless-m4t-medium [audio] -- 12L d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=256206 -- enc-dec, multimodal [arXiv:2308.11596; hf]

The audio frontend (fbank conv feature extractor) is a STUB: ``input_specs``
provides precomputed frame embeddings of shape (batch, encoder_len, d_model);
the transformer backbone (12L encoder + 12L decoder with cross-attention)
is implemented in full.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,               # decoder layers
    encoder_layers=12,
    encoder_len=1024,          # stub audio frames after feature extraction
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    rope_theta=10_000.0,
))
