"""End-to-end training driver example on the PyTorch/CUDA port: train a
~100M-parameter llama-family model for a few hundred steps on synthetic
data, with fault-tolerant checkpointing.

  PYTHONPATH=src python examples/train_100m_torch.py [--steps 300]
  PYTHONPATH=src python examples/train_100m_torch.py --reduced --device cpu

(~100M params: 12L x d512 on a 32k vocab, float32, on the card by default;
--tiny for the tiny model, --reduced for its same-family reduction.
Checkpoints go to the checkout's build/ckpt_100m unless --ckpt-dir says
otherwise, and a rerun resumes from the latest one.)
"""
import argparse
import sys
from pathlib import Path

from repro_torch.configs import base as cfgbase
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import train as train_mod

CKPT = Path(__file__).resolve().parents[1] / "build" / "ckpt_100m"

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--tiny", action="store_true")
args, rest = ap.parse_known_args()

if args.tiny:
    cfg = ArchConfig(name="demo-tiny", family="dense", n_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
                     head_dim=16, dtype="float32", remat=False)
    batch, seq = 8, 64
else:
    cfg = ArchConfig(name="demo-100m", family="dense", n_layers=12, d_model=512,
                     n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=32_000,
                     dtype="float32", remat=False)
    batch, seq = 8, 256

cfgbase.register(cfg)
sys.argv = ["train", "--arch", cfg.name, "--steps", str(args.steps),
            "--batch", str(batch), "--seq", str(seq),
            "--ckpt-dir", str(CKPT), "--ckpt-every", "100",
            "--resume"] + rest
train_mod.main()
