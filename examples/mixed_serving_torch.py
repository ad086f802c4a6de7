"""Mixed-workload serving on the PyTorch/CUDA port: the paper's deployment
story on the card.

A live UFS kernel schedules one device slot between:
  * an inference engine serving interactive requests (time-sensitive tier),
  * a background trainer running microbatches (background tier),
with hint-instrumented engine locks guarding the KV-slot allocator.  On the
card it serves qwen2-0.5b at its published widths and depth (the prefill
and decode kernels K1 and K2, and K1's backward in the training lane).

Compare against --policy fifo / rr / vdf to see background work delay the
interactive class.

  PYTHONPATH=src python examples/mixed_serving_torch.py [--policy ufs]
  PYTHONPATH=src python examples/mixed_serving_torch.py --reduced --device cpu
"""
import sys

from repro_torch.launch import serve

if __name__ == "__main__":
    sys.argv = ["serve", "--arch", "qwen2-0.5b", "--no-reduced",
                "--requests", "8", "--max-new-tokens", "8",
                "--background-train"] + sys.argv[1:]
    serve.main()
