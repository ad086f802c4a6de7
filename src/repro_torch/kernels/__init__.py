"""Hand-written Hopper kernels for the serving path, each with a wrapper
that counts its launches and a plain PyTorch version in ``ref``:

* flash_attention  -- prefill attention (``csrc/flash_attention.cu``)
* decode_attention -- single-token attention over the KV cache
  (``csrc/decode_attention.cu``)

``ops`` dispatches by device; ``build`` compiles the CUDA sources at first
use.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
