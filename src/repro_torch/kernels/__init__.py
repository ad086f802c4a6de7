"""Hand-written Hopper kernels for the serving and training paths, each
with a wrapper that counts its launches and a plain PyTorch version in
``ref``:

* flash_attention  -- prefill attention (``csrc/flash_attention.cu``) and
  its gradient, ``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``)
* decode_attention -- single-token attention over the KV cache
  (``csrc/decode_attention.cu``)
* mlstm_scan       -- chunkwise mLSTM recurrence (``csrc/mlstm_scan.cu``)
* moe_topk         -- MoE router: softmax, top-k, renormalise, and the
  capacity dispatch plan, in one launch (``csrc/moe_topk.cu``)

``ops`` dispatches by device; ``build`` compiles the CUDA sources at first
use.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
