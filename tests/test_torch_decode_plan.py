"""K2's bf16 kernel (``decode_mma_kernel``) on the CPU: its plan, the
ranges it gives each split on the device, its split-and-merge arithmetic
against the dense plain version and the reference's Pallas kernel in
interpret mode (float32, 2e-5), and a plain emulation of its bf16 rounding
points -- q as given, P rounded to bf16 before P V, float32 running state
-- against the plain version within the bf16 gates (3e-2 of max(1, max
|plain|)).  The kernel itself is held against the plain version on the
card (tests/test_torch_kernels_gpu.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import ref as tref


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------- the mma plan
@pytest.mark.parametrize("s_max,b,kh", [
    (1024, 8, 8),        # llama3.2-1b decode step: 64 (row, KV head) pairs
    (1024, 8, 5),        # hymba-1.5b: 40 pairs
    (2048, 8, 5),        # hymba's global layers at S_max 2048
    (1024, 8, 16),       # qwen2-moe-a2.7b, seamless cross-attention: 128
    (1024, 8, 32),       # stablelm-3b: 256 pairs
    (1024, 8, 2),        # qwen2-0.5b: 16 pairs, past one cluster
    (1000, 3, 2),        # S_max not a multiple of the tile
    (64, 1, 1),          # one tile
    (5, 2, 2),           # shorter than a tile
    (512, 64, 16),       # more pairs than SMs: one block a pair
    (131072, 1, 1),      # a long cache: groups of clusters
])
def test_mma_plan_covers_the_cache_once(s_max, b, kh):
    """Clusters of 1, 2, 4 or 8 blocks; one cluster a pair within one block
    an SM, or, where the split kernel's plan passes a cluster, at least its
    count of blocks in whole clusters; every live length of the cache cut
    into splits that cover it once, none empty at S_max."""
    cluster, groups = tdecode.mma_plan(s_max, b, kh)
    n = cluster * groups
    assert cluster in (1, 2, 4, 8) and groups >= 1
    split_n, _ = tdecode.split_plan(s_max, b, kh)
    if groups == 1:
        assert n <= split_n
        assert n == 1 or b * kh * n <= tdecode.H100_SMS
    else:
        assert cluster == tdecode.MAX_CLUSTER
        assert split_n <= n < split_n + tdecode.MAX_CLUSTER
    for length in sorted({0, 1, s_max // 3, s_max - 1, s_max}):
        covered = np.zeros(max(length, 1), np.int32)
        ranges = tdecode.mma_ranges(length, n)
        assert len(ranges) == n
        for lo, hi in ranges:
            covered[lo:hi] += 1
        assert (covered[:length] == 1).all()
        assert [lo for lo, _ in ranges] == sorted(lo for lo, _ in ranges)
        if length == s_max and s_max >= n:
            assert all(lo < hi for lo, hi in ranges)


@pytest.mark.parametrize("length,n", [(700, 2), (700, 8), (1, 8), (0, 4),
                                      (1023, 16), (5, 4)])
def test_mma_ranges_are_equal_shares(length, n):
    """Each split holds floor or ceil of length / n positions, in order."""
    ranges = tdecode.mma_ranges(length, n)
    sizes = [hi - lo for lo, hi in ranges]
    assert sum(sizes) == length
    assert max(sizes) - min(sizes) <= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == length
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


# ------------------------------------------- its split-and-merge arithmetic
@pytest.mark.parametrize("b,s,h,kh,d,lengths,n_split", [
    (2, 256, 8, 2, 16, [100, 256], 2),      # G = 4, S_max in full
    (3, 200, 14, 2, 32, [0, 1, 129], 4),    # G = 7, lengths 0 and 1
    (2, 192, 4, 4, 64, [63, 65], 8),        # G = 1, splits of 8 positions
    (2, 100, 16, 1, 16, [64, 99], 2),       # G = 16
    (2, 300, 10, 2, 80, [300, 17], 16),     # G = 5, hd 80, two clusters
])
def test_mma_ref_matches_dense_and_pallas(b, s, h, kh, d, lengths, n_split):
    """The kernel's splits (equal shares of each row's length), 16-position
    tiles over its warps and merge order, in float32 without the bf16
    rounding of P, against the dense plain version (rows with live
    positions) and the reference's Pallas kernel in interpret mode on the
    head-expanded (BH, 1, D) form (every row, length 0 included: both give 0
    there)."""
    q, k, v = rand((b, 1, h, d), 13), rand((b, s, kh, d), 14), rand((b, s, kh, d), 15)
    lens = np.array(lengths, np.int32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o = tref.grouped_decode_mma_ref(tq, tk, tv, torch.from_numpy(lens),
                                    n_split=n_split, round_p=False)
    dense = tref.grouped_decode_ref(tq, tk, tv, torch.from_numpy(lens))
    live = lens > 0
    assert (o - dense)[live].abs().max().item() < 2e-5
    assert (o[~live] == 0).all()
    g = h // kh
    qf = q.transpose(0, 2, 1, 3).reshape(b * h, 1, d)
    kf = np.repeat(k.transpose(0, 2, 1, 3), g, axis=1).reshape(b * h, s, d)
    vf = np.repeat(v.transpose(0, 2, 1, 3), g, axis=1).reshape(b * h, s, d)
    r = jops.decode_attention(jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(vf),
                              jnp.asarray(np.repeat(lens, h)),
                              backend="interpret", block_k=s)
    r = np.asarray(r).reshape(b, h, 1, d).transpose(0, 2, 1, 3)
    assert np.max(np.abs(o.numpy() - r)) < 2e-5


# -------------------------------------------------- its bf16 rounding points
@pytest.mark.parametrize("g", [1, 4, 5, 7, 16])
@pytest.mark.parametrize("d", [16, 80])
def test_mma_rounding_emulation_within_bf16_gates(g, d):
    """bf16 q and cache as given, P rounded to bf16 before P V, the running
    max, sum and accumulator float32: within 3e-2 of max(1, max |plain|) of
    the plain version on the same bf16 inputs, on the plan's splits."""
    b, s, kh = 3, 300, 2
    h = g * kh
    q, k, v = (torch.from_numpy(rand(shape, seed)).bfloat16()
               for shape, seed in (((b, 1, h, d), 20), ((b, s, kh, d), 21),
                                   ((b, s, kh, d), 22)))
    lens = torch.tensor([300, 1, 157], dtype=torch.int32)
    cluster, groups = tdecode.mma_plan(s, b, kh)
    got = tref.grouped_decode_mma_ref(q, k, v, lens, n_split=cluster * groups)
    want = tref.grouped_decode_ref(q, k, v, lens).float()
    assert got.dtype == torch.bfloat16
    err = (got.float() - want).abs().max().item()
    assert err < 3e-2 * max(1.0, want.abs().max().item())
