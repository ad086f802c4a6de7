"""The CUDA kernels against their plain versions on the card.

Run on a machine with an H100 (``pytest -m gpu tests/test_torch_kernels_gpu.py``);
without a CUDA device every test skips.  Whether there is a device is decided
in the ``cuda`` fixture, never at import, so every pytest-xdist worker
collects the same tests.  Attention (head dims 16, 32, 64, 80 and 128, and
K1 at MLA's query-key dim 192 with value dim 128):
float32 to 1e-4 (the kernel sums in another order and uses the device
``exp``), bfloat16 to 3e-2.  Router:
indices identical, weights to 1e-6.  mLSTM scan: float32 to 1e-3 (the
reference's bound for chunkwise against the recurrence; kernel and plain
version cut the sequence into chunks of different lengths), bfloat16 to
3e-2 of max(1, max |plain|), under both of its plans.  Router with its
dispatch plan: indices, slots, slot tokens and counts identical, weights to
1e-6, probability sums to 1e-5 relative (summed in another order).  K1's
backward against ``ref.grouped_flash_bwd_ref`` fed the plain forward's
output and logsumexp: float32 to 1e-4 and bfloat16 to 3e-2, each of max(1,
max |plain|) (sums over S in another order), and the error's norm within
1e-4 (float32) and 1e-2 (bfloat16) of the plain gradient's; the forward's
row logsumexp on its live rows, float32 to 1e-5 and bfloat16 to 1e-4.
K1's backward at MLA's (192, 128), K3's backward against
``ref.mlstm_chunkwise_bwd_ref`` and K4's against ``ref.moe_route_bwd_ref``
on the same inputs: the same two gates (max error of max(1, max |plain|)
and error norm); the MoE and xLSTM / hymba training gradients bit-identical
from call to call, each family's float32 training gradient through the
kernels against the plain path."""
import dataclasses
import re

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import decode_attention as kdecode
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import mlstm_scan as kscan
from repro_torch.kernels import moe_topk as kmoe
from repro_torch.kernels import ops, ref
from repro_torch.models import moe as tmoe

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kh,hd,causal,window", [
    (8, 256, 256, 32, 8, 64, True, 0),      # llama3.2-1b prefill
    (1, 500, 500, 32, 8, 64, True, 0),      # ragged bulk prefill
    (2, 256, 256, 14, 2, 64, True, 0),      # qwen2-0.5b, G = 7
    (1, 512, 512, 8, 2, 64, True, 128),     # sliding window
    (2, 64, 256, 4, 4, 32, False, 0),       # non-causal, Sq != Sk
    (3, 128, 128, 3, 3, 16, True, 0),
    (1, 512, 512, 1, 1, 128, True, 0),
    (8, 256, 256, 16, 16, 128, True, 0),    # qwen2-moe-a2.7b prefill
    (2, 64, 200, 8, 2, 64, True, 48),       # one 64-row tile, Sq != Sk, window
    (1, 500, 500, 14, 2, 128, True, 0),     # ragged, G = 7, hd 128
    (2, 100, 300, 4, 2, 32, False, 0),      # non-causal, ragged Sq != Sk
    (2, 200, 200, 4, 1, 16, True, 64),      # hd 16, window
    (1, 300, 300, 14, 2, 32, True, 100),    # G = 7, window
    (8, 256, 256, 32, 32, 80, True, 0),     # stablelm-3b prefill, hd 80
    (1, 500, 500, 32, 32, 80, True, 0),     # hd 80, ragged
    (2, 300, 300, 8, 8, 80, True, 100),     # hd 80, window, ragged
    (2, 100, 300, 4, 2, 80, False, 0),      # hd 80, non-causal, Sq != Sk
    (2, 64, 200, 8, 2, 80, True, 48),       # hd 80, one 64-row tile, window
    (8, 256, 256, 25, 5, 64, True, 1024),   # hymba-1.5b prefill, G = 5
    (1, 1100, 1100, 25, 5, 64, True, 1024), # hymba past its window
    (8, 1024, 1024, 16, 16, 64, False, 0),  # seamless encoder, unmasked
    (8, 256, 1024, 16, 16, 64, False, 0),   # seamless cross-attn prefill
    (8, 1, 1024, 16, 16, 64, False, 0),     # cross-attn decode, Sq = 1
    (8, 37, 1024, 16, 16, 64, False, 0),    # ragged Sq = 37 under one tile
    (3, 1, 300, 14, 2, 64, True, 0),        # Sq = 1, causal
    # the TMA design's edges: 128-key and 128-query tiles, boxes at hd 16,
    # 32 and 80 (zero-filled past Sq, Sk and column 80), G = 5 and 7
    (2, 1, 1024, 16, 16, 64, False, 0),     # Sq = 1 over Sk = 1024
    (2, 37, 1024, 16, 16, 64, True, 0),     # Sq = 37 over 1024, causal
    (2, 129, 129, 4, 2, 64, True, 0),       # one row and one key past a tile
    (2, 127, 255, 4, 1, 32, False, 0),      # one short of each tile
    (3, 300, 300, 6, 2, 16, True, 0),       # hd 16 box (32 bytes)
    (2, 333, 333, 6, 3, 32, True, 0),       # hd 32 box (64 bytes)
    (2, 257, 257, 10, 2, 80, True, 0),      # hd 80: a 128- and a 32-byte box
    (2, 700, 700, 10, 2, 80, True, 200),    # hd 80, window across tiles
    (2, 300, 300, 25, 5, 64, True, 100),    # G = 5, window inside a tile
    (1, 700, 700, 14, 2, 128, True, 0),     # G = 7 at hd 128
    (1, 640, 640, 7, 1, 64, True, 130),     # window 130: crosses tile edges
    (1, 1000, 1200, 8, 2, 64, True, 300),   # Sq < Sk, window, causal
    (4, 2048, 2048, 16, 4, 64, True, 0),    # 1024 work tiles, 8 per SM
    (2, 4096, 4096, 32, 8, 64, True, 0),    # llama's training shape
])
def test_flash_kernel_matches_plain(cuda, dtype, b, sq, sk, h, kh, hd,
                                    causal, window):
    q = _randn((b, sq, h, hd), dtype, cuda, 1)
    k = _randn((b, sk, kh, hd), dtype, cuda, 2)
    v = _randn((b, sk, kh, hd), dtype, cuda, 3)
    n = kflash.launches.count
    out = kflash.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kflash.launches.count == n + 1
    want = ref.grouped_flash_ref(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype
    assert (out.float() - want.float()).abs().max().item() < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kh,causal", [
    (8, 256, 256, 128, 128, True),      # deepseek-v3 MLA admission
    (1, 500, 500, 128, 128, True),      # ragged MLA bulk prefill
    (2, 100, 100, 4, 4, True),          # a small MLA, one ragged tile
    (2, 70, 300, 4, 2, False),          # unmasked, Sq != Sk, G = 2
    (3, 1, 200, 4, 4, True),            # Sq = 1
    (1, 2048, 2048, 16, 16, True),      # deepseek's training length
    (2, 129, 385, 6, 3, True),          # past a tile each way, G = 2
])
def test_flash_kernel_at_mla_dims_matches_plain(cuda, dtype, b, sq, sk, h,
                                                kh, causal):
    """Query-key dim 192, value dim 128, as MLA's prefill calls K1: V a
    strided view of a packed (K_nope, V) tensor, the scale 192 ** -0.5."""
    q = _randn((b, sq, h, 192), dtype, cuda, 31)
    k = _randn((b, sk, kh, 192), dtype, cuda, 32)
    v = _randn((b, sk, kh, 256), dtype, cuda, 33)[..., 128:]
    n = kflash.launches.count
    out = kflash.flash_attention(q, k, v, causal=causal, scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert kflash.launches.count == n + 1
    assert out.shape == (b, sq, h, 128) and out.dtype == dtype
    want = ref.grouped_flash_ref(q, k, v, causal=causal, scale=192 ** -0.5)
    assert (out.float() - want.float()).abs().max().item() < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,causal", [(64, True), (128, True), (80, False),
                                       (192, True)])
def test_flash_kernel_reads_strided_views_of_one_projection(cuda, dtype, hd,
                                                            causal):
    """q, k and v as views of one fused (B, S, H + 2 KH, hd) projection,
    every stride but the head dim's not packed; at 192 the value a
    128-column view of the key's row, as MLA passes it."""
    b, s, h, kh = 2, 300, 8, 2
    fused = _randn((b, s, h + 2 * kh, hd), dtype, cuda, 41)
    q, k = fused[:, :, :h], fused[:, :, h:h + kh]
    v = fused[:, :, h + kh:, :128] if hd == 192 else fused[:, :, h + kh:]
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    out = kflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = ref.grouped_flash_ref(q, k, v, causal=causal)
    assert (out.float() - want.float()).abs().max().item() < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,layout", [(64, "expanded_kv"),
                                       (80, "expanded_kv"),
                                       (192, "expanded_kv"), (64, "offset_q"),
                                       (80, "offset_k"), (128, "offset_v")])
def test_flash_kernel_takes_what_no_tensor_map_describes(cuda, dtype, hd,
                                                         layout):
    """K and V expanded over their KV heads (stride 0), or q, k or v one
    element into its storage (rows off 16 bytes): bf16 copies each such
    input once (``tma_copies``) and matches the plain version; float32
    reads them as they are (no copy)."""
    b, s, h, kh = 2, 300, 8, 2
    dv = 128 if hd == 192 else hd
    t = {"q": _randn((b, s, h, hd), dtype, cuda, 51),
         "k": _randn((b, s, kh, hd), dtype, cuda, 52),
         "v": _randn((b, s, kh, dv), dtype, cuda, 53)}
    if layout == "expanded_kv":
        t["k"] = _randn((b, s, 1, hd), dtype, cuda, 54).expand(b, s, kh, hd)
        t["v"] = _randn((b, s, 1, dv), dtype, cuda, 55).expand(b, s, kh, dv)
        copied = 2
    else:
        name = layout[-1]
        shape = t[name].shape
        t[name] = _randn((t[name].numel() + 1,), dtype, cuda, 56)[1:].view(
            shape)
        copied = 1
    n, c = kflash.launches.count, kflash.tma_copies.count
    out = kflash.flash_attention(t["q"], t["k"], t["v"], causal=True)
    torch.cuda.synchronize()
    assert kflash.launches.count == n + 1
    assert kflash.tma_copies.count == c + (copied if dtype == torch.bfloat16
                                           else 0)
    want = ref.grouped_flash_ref(t["q"], t["k"], t["v"], causal=True)
    assert (out.float() - want.float()).abs().max().item() < TOL[dtype]


@pytest.mark.parametrize("hd,dv", [(64, 64), (80, 80), (192, 128)])
def test_flash_watchdog_build_matches_plain(cuda, hd, dv):
    """The watchdog build of K1 (``-DREPRO_MBAR_WATCHDOG``: every mbarrier
    wait traps after a bounded number of tries) against the plain version
    at bf16 3e-2, over more work tiles than SMs, and bit for bit the
    production build's output; its launches count apart."""
    b, s, h, kh = 4, 1000, 16, 4
    q = _randn((b, s, h, hd), torch.bfloat16, cuda, 61)
    k = _randn((b, s, kh, hd), torch.bfloat16, cuda, 62)
    v = _randn((b, s, kh, 128 + dv), torch.bfloat16, cuda, 63)[..., 128:] \
        if hd == 192 else _randn((b, s, kh, hd), torch.bfloat16, cuda, 63)
    n, w = kflash.launches.count, kflash.watchdog_launches.count
    out, lse = kflash.flash_attention_watchdog(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert kflash.watchdog_launches.count == w + 1
    assert kflash.launches.count == n
    want = ref.grouped_flash_ref(q, k, v)
    assert (out.float() - want.float()).abs().max().item() < TOL[torch.bfloat16]
    prod, plse = kflash.flash_attention(q, k, v, return_lse=True)
    assert torch.equal(out, prod) and torch.equal(lse, plse)


@pytest.mark.parametrize("b,sq,sk,h,kh,hd,dv,causal", [
    (8, 1024, 1024, 16, 16, 64, 64, False),     # seamless encoder
    (8, 256, 256, 128, 128, 192, 128, True),    # deepseek MLA admission
    (2, 4096, 4096, 32, 8, 64, 64, True),       # llama training
])
def test_flash_kernel_bf16_is_bit_identical_and_keeps_lse(cuda, b, sq, sk, h,
                                                         kh, hd, dv, causal):
    """Two calls give the same bits (no atomics; the persistent walk's
    order is fixed), and the row logsumexp on the live rows is within 1e-4
    of the plain one (rows that see no key: -inf in both); the bf16 TMA
    kernel is what ran."""
    dt = torch.bfloat16
    q = _randn((b, sq, h, hd), dt, cuda, 51)
    k = _randn((b, sk, kh, hd), dt, cuda, 52)
    v = (_randn((b, sk, kh, 128 + dv), dt, cuda, 53)[..., 128:] if dv != hd
         else _randn((b, sk, kh, dv), dt, cuda, 53))
    n = kflash.tma_launches.count
    o1, lse1 = kflash.flash_attention(q, k, v, causal=causal, return_lse=True)
    o2, lse2 = kflash.flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert kflash.tma_launches.count == n + 2
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    want, plse = ref.grouped_flash_ref(q, k, v, causal=causal,
                                       return_lse=True)
    assert (o1.float() - want.float()).abs().max().item() < TOL[dt]
    live = torch.isfinite(plse)
    assert torch.equal(live, torch.isfinite(lse1))
    assert (lse1[live] - plse[live]).abs().max().item() < 1e-4


@pytest.mark.parametrize("hd,dv", [(64, 64), (80, 80), (192, 128)])
def test_flash_forward_launches_the_kernel_of_its_input_type(cuda, hd, dv):
    """bfloat16 runs the TMA kernel (``flash_fwd_tma_kernel``), float32
    the CUDA-core one (``flash_fwd_kernel``), one launch a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for dtype, name in ((torch.bfloat16, f"flash_fwd_tma_kernel<{hd}, {dv}>"),
                        (torch.float32, f"flash_fwd_kernel<{hd}, {dv}>")):
        q = _randn((2, 300, 4, hd), dtype, cuda, 71)
        k = _randn((2, 300, 2, hd), dtype, cuda, 72)
        v = _randn((2, 300, 2, dv), dtype, cuda, 73)
        kflash.flash_attention(q, k, v)
        torch.cuda.synchronize()
        for _ in range(3):          # the profiler can drop device events
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                kflash.flash_attention(q, k, v)
                torch.cuda.synchronize()
            names = {e.key for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and e.count}
            if names:
                break
        assert len(names) == 1 and name in next(iter(names)), names


def test_flash_kernel_rows_that_see_no_key_get_zero(cuda):
    """Causal with Sq > Sk: the first Sq - Sk query rows (whole 128-row
    work tiles among them) see no key: output 0 and logsumexp -inf."""
    dt = torch.bfloat16
    q = _randn((2, 400, 4, 64), dt, cuda, 61)
    k = _randn((2, 100, 2, 64), dt, cuda, 62)
    v = _randn((2, 100, 2, 64), dt, cuda, 63)
    out, lse = kflash.flash_attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    assert (out[:, :300] == 0).all()
    assert torch.isneginf(lse[:, :, :300]).all()
    want = ref.grouped_flash_ref(q, k, v, causal=True)
    assert (out[:, 300:].float() - want[:, 300:].float()).abs().max() < 3e-2


@pytest.mark.parametrize("hd,hdv", [(128, 64), (64, 128), (192, 192),
                                    (192, 64), (128, 192)])
def test_flash_kernel_refuses_other_unequal_dims(cuda, hd, hdv):
    q = torch.zeros((1, 8, 4, hd), device=cuda, dtype=torch.bfloat16)
    v = torch.zeros((1, 8, 4, hdv), device=cuda, dtype=torch.bfloat16)
    n = kflash.launches.count
    with pytest.raises(ValueError, match="head dims"):
        kflash.flash_attention(q, q, v)
    assert kflash.launches.count == n


def _decode_check(out, q, k, v, lens, dtype):
    """Rows with live positions against the dense plain version; a row of
    length 0 gets 0, as the Pallas kernel gives (the dense plain version
    gives the mean of V there)."""
    want = ref.grouped_decode_ref(q, k, v, lens)
    live = lens > 0
    if live.any():
        assert (out.float() - want.float())[live].abs().max().item() < TOL[dtype]
    assert (out[~live] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh,hd,lengths", [
    (8, 1024, 32, 8, 64, [700] * 8),                      # llama decode
    (8, 1024, 32, 8, 64, [1, 63, 64, 65, 300, 700, 1000, 1024]),
    (4, 512, 14, 2, 64, [500, 17, 512, 256]),             # qwen, G = 7
    (6, 512, 1, 1, 64, [1, 86, 171, 256, 341, 426]),      # (BH, 1, D) form
    (2, 2048, 1, 1, 128, [1, 1025]),
    (8, 256, 1, 1, 32, [1, 33, 65, 97, 129, 161, 193, 225]),
    (8, 1024, 32, 32, 80, [700] * 8),                     # stablelm-3b, hd 80
    (8, 1024, 32, 32, 80, [1, 63, 64, 65, 300, 700, 1000, 1024]),
    (3, 300, 4, 2, 80, [300, 1, 150]),                    # hd 80, G = 2
    (8, 1024, 25, 5, 64, [1024, 700, 1, 500, 64, 65, 900, 128]),  # hymba
    (8, 1024, 25, 5, 64, [700] * 8),                      # hymba, G = 5
    (8, 1024, 35, 5, 64, [0, 1, 1024, 700, 17, 512, 999, 64]),  # G = 7
    (4, 300, 16, 4, 16, [0, 1, 300, 150]),                # G = 4 at every hd
    (4, 300, 16, 4, 32, [0, 1, 300, 150]),
    (4, 300, 16, 4, 64, [0, 1, 300, 150]),
    (4, 300, 16, 4, 80, [0, 1, 300, 150]),
    (4, 300, 16, 4, 128, [0, 1, 300, 150]),
    (8, 1000, 32, 8, 64, [1000, 0, 1, 999, 500, 128, 129, 700]),  # S_max 1000
    (8, 1024, 32, 2, 128, [700, 0, 1, 1024, 3, 64, 65, 511]),  # G = 16, hd 128
])
def test_decode_kernel_matches_plain(cuda, dtype, b, s, h, kh, hd, lengths):
    q = _randn((b, 1, h, hd), dtype, cuda, 4)
    k = _randn((b, s, kh, hd), dtype, cuda, 5)
    v = _randn((b, s, kh, hd), dtype, cuda, 6)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    n = kdecode.launches.count
    out = kdecode.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert kdecode.launches.count == n + 1
    _decode_check(out, q, k, v, lens, dtype)


def _edge_lengths(s, b, kh, dtype):
    """0, 1, S_max and the lengths about the plan's split edges, cycled over
    the batch rows: the float32 split kernel's first boundary -1, 0, +1; the
    bf16 mma kernel's n_split - 1, n_split, n_split + 1 (from where every
    split has a position) and one past a multiple of n_split."""
    if dtype == torch.bfloat16:
        cluster, groups = kdecode.mma_plan(s, b, kh)
        n = cluster * groups
        edge = [0, 1, n - 1, n, n + 1, s, (s // n) * n + 1]
    else:
        _, chunk = kdecode.split_plan(s, b, kh)
        edge = [0, 1, chunk - 1, chunk, chunk + 1, s]
    return [min(s, edge[i % len(edge)]) for i in range(b)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh,hd", [
    (8, 1024, 16, 16, 128),     # qwen2-moe-a2.7b decode, G = 1
    (8, 1024, 32, 8, 64),       # llama3.2-1b, G = 4
    (6, 1024, 14, 2, 64),       # qwen2-0.5b, G = 7
    (6, 512, 32, 2, 64),        # G = 16 (MAX_GROUP)
    (6, 512, 16, 1, 128),       # G = 16, hd 128
    (6, 700, 8, 2, 32),         # S_max not a multiple of the tile
    (6, 256, 8, 8, 16),         # hd 16
    (8, 1024, 32, 32, 80),      # stablelm-3b decode, hd 80, G = 1
    (6, 512, 32, 2, 80),        # hd 80, G = 16
    (8, 1024, 25, 5, 64),       # hymba-1.5b, G = 5
    (8, 2048, 25, 5, 64),       # hymba's global layers at S_max 2048
    (8, 1024, 56, 8, 64),       # G = 7 at hd 64
    (8, 1000, 32, 8, 64),       # S_max 1000
])
def test_decode_kernel_split_edges(cuda, dtype, b, s, h, kh, hd):
    """Lengths at the split plan's edges, of the plan of the kernel the
    dtype runs."""
    q = _randn((b, 1, h, hd), dtype, cuda, 13)
    k = _randn((b, s, kh, hd), dtype, cuda, 14)
    v = _randn((b, s, kh, hd), dtype, cuda, 15)
    lens = torch.tensor(_edge_lengths(s, b, kh, dtype), dtype=torch.int32,
                        device=cuda)
    out = kdecode.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    _decode_check(out, q, k, v, lens, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh", [
    (8, 1024, 32, 8),           # llama3.2-1b: one cluster a pair
    (8, 1024, 14, 2),           # qwen2-0.5b: two clusters, the counters
])
def test_decode_kernel_is_deterministic_and_leaves_counters_zero(
        cuda, dtype, b, s, h, kh):
    """Two back-to-back calls on one stream give bit-identical outputs: the
    arrival counters are back at 0 after each call, and every merge reads
    the partials in split order, whichever block arrives last."""
    hd = 64
    q = _randn((b, 1, h, hd), dtype, cuda, 16)
    k = _randn((b, s, kh, hd), dtype, cuda, 17)
    v = _randn((b, s, kh, hd), dtype, cuda, 18)
    lens = torch.tensor([700, 1, 1024, 129, 128, 127, 500, 64],
                        dtype=torch.int32, device=cuda)
    first = kdecode.decode_attention(q, k, v, lens)
    second = kdecode.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert not kdecode._counter_buffer(q.device, stream, b * kh).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_at_head_dim_80_is_deterministic(cuda, dtype):
    """hd 80 (the split kernel reads a row with 10 of a 16-lane group, the
    mma kernel in 5 k16 steps): two calls still give bit-identical outputs,
    and the counters are back at 0."""
    b, s, h, kh, hd = 8, 1024, 32, 32, 80
    q = _randn((b, 1, h, hd), dtype, cuda, 19)
    k = _randn((b, s, kh, hd), dtype, cuda, 20)
    v = _randn((b, s, kh, hd), dtype, cuda, 21)
    lens = torch.tensor([700, 1, 1024, 129, 128, 127, 500, 64],
                        dtype=torch.int32, device=cuda)
    first = kdecode.decode_attention(q, k, v, lens)
    second = kdecode.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert not kdecode._counter_buffer(q.device, stream, b * kh).any()


@pytest.mark.parametrize("dtype,kernel", [
    (torch.float32, "decode_split_kernel"),
    (torch.bfloat16, "decode_mma_kernel"),
])
@pytest.mark.parametrize("b,s,h,kh,hd", [
    (8, 1024, 32, 8, 64),       # llama3.2-1b
    (8, 1024, 16, 16, 128),     # qwen2-moe-a2.7b, G = 1
    (1, 8192, 8, 1, 64),        # a long cache: clusters in groups
])
def test_decode_launches_the_kernel_of_its_input_type(cuda, dtype, kernel,
                                                      b, s, h, kh, hd):
    """bf16 runs the tensor-core kernel (one launch a call), float32 the
    split kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    q = _randn((b, 1, h, hd), dtype, cuda, 22)
    k = _randn((b, s, kh, hd), dtype, cuda, 23)
    v = _randn((b, s, kh, hd), dtype, cuda, 24)
    lens = torch.full((b,), s - 3, dtype=torch.int32, device=cuda)
    kdecode.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    for _ in range(3):          # the profiler can drop device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            kdecode.decode_attention(q, k, v, lens)
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.count}
        if names:
            break
    assert any(kernel in n for n in names), names
    assert not any("decode_" in n and kernel not in n for n in names), names


def test_decode_kernels_build_without_spill(cuda, tmp_path, monkeypatch):
    """ptxas reports no spill in any instantiation of either K2 kernel (the
    mma kernel's launch bounds leave hd 80 and 128 the registers they
    need; builds of it made to spill gave wrong bits), and builds both at
    every head dim and head-group bound: the mma kernel for bf16, the split
    kernel for float32."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    _, _, log_ = build.build(("decode_attention",))["decode_attention"]
    kernels = re.findall(r"Compiling entry function '\w*?"
                         r"(decode_(?:mma|split)_kernel)I", log_)
    assert kernels.count("decode_mma_kernel") == 10, kernels
    assert kernels.count("decode_split_kernel") == 20, kernels
    assert not [ln for ln in log_.splitlines()
                if re.search(r"[1-9]\d* bytes spill", ln)], log_


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((1, 8, 4, 48), device=cuda)             # hd 48
    with pytest.raises(ValueError, match="head dim"):
        kflash.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 1, 4, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        kdecode.decode_attention(q, q, q, torch.ones(1, dtype=torch.int32,
                                                     device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [8, 500, 2048])
@pytest.mark.parametrize("e,k,n_valid", [(64, 4, 60), (256, 8, 256), (16, 2, 16)])
def test_router_kernel_matches_plain(cuda, dtype, t, e, k, n_valid):
    logits = _randn((t, e), dtype, cuda, 7)
    n = kmoe.launches.count
    w, idx = kmoe.moe_topk(logits, k, n_valid)
    torch.cuda.synchronize()
    assert kmoe.launches.count == n + 1
    rw, ridx = ref.moe_topk_ref(logits, k, n_valid)
    assert torch.equal(idx, ridx)
    assert (w - rw).abs().max().item() < 1e-6


def test_router_kernel_ties_go_to_lowest_index(cuda):
    logits = (torch.randint(-2, 3, (512, 64), device=cuda) / 2).bfloat16()
    w, idx = kmoe.moe_topk(logits, 4, 60)
    rw, ridx = ref.moe_topk_ref(logits, 4, 60)
    assert torch.equal(idx, ridx)
    assert (w - rw).abs().max().item() < 1e-6


def _route_close(got, want):
    for name in ("idx", "slot", "slot_tok", "counts"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert (got.weights - want.weights).abs().max().item() < 1e-6
    err = (got.prob_sum - want.prob_sum).abs()
    assert (err <= 1e-5 * want.prob_sum.abs()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 3, 8, 37, 500, 2048, 8192])
@pytest.mark.parametrize("e,k,n_valid", [(8, 1, 8), (16, 2, 12), (64, 4, 60),
                                         (256, 8, 256)])
def test_route_kernel_matches_plain(cuda, dtype, t, e, k, n_valid):
    """All six outputs, one launch a call, at capacities that drop pairs,
    the prefill default, the decode default and one that drops none."""
    logits = _randn((t, e), dtype, cuda, 19)
    caps = {tmoe.capacity(t, k, cf, e) for cf in (0.5, 1.25, 2.0)} | {t}
    for cap in sorted(caps):
        n = kmoe.launches.count
        got = kmoe.moe_route(logits, k, capacity=cap, n_valid=n_valid,
                             router_scale=2.5)
        torch.cuda.synchronize()
        assert kmoe.launches.count == n + 1
        _route_close(got, ref.moe_route_ref(logits, k, capacity=cap,
                                            n_valid=n_valid, router_scale=2.5))


@pytest.mark.parametrize("t", [8, 2048])
def test_route_kernel_ties_and_strided_logits(cuda, t):
    """bfloat16 logits rounded to halves (ties go to the lowest index), read
    through a row stride wider than the experts."""
    wide = (torch.randint(-2, 3, (t, 80), device=cuda) / 2).bfloat16()
    logits = wide[:, :64]
    cap = tmoe.capacity(t, 4, 1.25, 64)
    _route_close(kmoe.moe_route(logits, 4, capacity=cap, n_valid=60),
                 ref.moe_route_ref(logits, 4, capacity=cap, n_valid=60))


@pytest.mark.parametrize("t,cap", [(8, 1), (2048, 160), (8192, 40)])
def test_route_kernel_is_deterministic(cuda, t, cap):
    """Repeated calls give identical bits: no atomics, every sum in a fixed
    order, and no counter or scratch carried from one call to the next."""
    logits = _randn((t, 64), torch.bfloat16, cuda, 20)
    first = kmoe.moe_route(logits, 4, capacity=cap, n_valid=60)
    for _ in range(3):
        again = kmoe.moe_route(logits, 4, capacity=cap, n_valid=60)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_route_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((8, 300), device=cuda)
    with pytest.raises(ValueError, match="experts"):
        kmoe.moe_route(x, 4, capacity=1)
    x = torch.zeros((8, 64), device=cuda)
    with pytest.raises(ValueError, match="top_k"):
        kmoe.moe_route(x, 9, capacity=1)
    with pytest.raises(ValueError, match="capacity"):
        kmoe.moe_route(x, 4, capacity=0)
    with pytest.raises(TypeError):
        kmoe.moe_route(x.half(), 4, capacity=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,cf", [(8, 1, 2.0), (4, 64, 1.25), (2, 64, 0.5)])
def test_moe_forward_on_the_card_is_bit_identical(cuda, monkeypatch, dtype,
                                                  b, s, cf):
    """No accumulating scatter: two calls of the layer give identical bits;
    in float32 the layer matches itself run through the plain router."""
    base = get_arch("qwen2-moe-a2.7b").reduced()
    cfg = dataclasses.replace(
        base, dtype=dtype, moe=dataclasses.replace(
            base.moe, n_routed=60, padded_routed=64, top_k=4))
    gen = torch.Generator(device=cuda).manual_seed(3)
    p = tmoe.moe_init(gen, cfg)
    p["router"]["w"] = p["router"]["w"] * 50     # experts fill and drop
    x = _randn((b, s, cfg.d_model), p["router"]["w"].dtype, cuda, 21)
    n = kmoe.launches.count
    y1, aux1 = tmoe.moe_forward(cfg, p, x, capacity_factor=cf)
    y2, aux2 = tmoe.moe_forward(cfg, p, x, capacity_factor=cf)
    torch.cuda.synchronize()
    assert kmoe.launches.count == n + 2
    assert torch.equal(y1, y2) and torch.equal(aux1, aux2)
    if dtype == "float32":
        monkeypatch.setattr(ops, "moe_route", ref.moe_route_ref)
        yp, auxp = tmoe.moe_forward(cfg, p, x, capacity_factor=cf)
        assert (y1 - yp).abs().max().item() < 1e-4
        assert abs(aux1.item() - auxp.item()) < 2e-5


def _scan_inputs(bh, s, dk, dv, dtype, device):
    q = (_randn((bh, s, dk), torch.float32, device, 8) * 0.5).to(dtype)
    k = (_randn((bh, s, dk), torch.float32, device, 9) * 0.5).to(dtype)
    v = _randn((bh, s, dv), dtype, device, 10)
    logf = torch.nn.functional.logsigmoid(
        _randn((bh, s), torch.float32, device, 11) + 2.0)
    i = torch.sigmoid(_randn((bh, s), torch.float32, device, 12))
    return q, k, v, logf, i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,dk,dv,scale", [
    (32, 256, 512, 512, None),       # xlstm-350m admission batch
    (4, 500, 512, 512, None),        # xlstm bulk prefill, ragged length
    (200, 256, 16, 64, 1.0),         # hymba's SSD heads
    (2, 256, 32, 32, None),          # reference test shapes
    (4, 128, 16, 64, None),
    (1, 512, 64, 64, None),
    (3, 37, 32, 96, None),           # ragged, dv not a multiple of 64
])
def test_scan_kernel_matches_plain(cuda, dtype, bh, s, dk, dv, scale):
    q, k, v, logf, i = _scan_inputs(bh, s, dk, dv, dtype, cuda)
    n = kscan.launches.count
    out = kscan.mlstm_scan(q, k, v, logf, i, scale=scale)
    torch.cuda.synchronize()
    assert kscan.launches.count == n + 1
    want = ref.mlstm_chunkwise_ref(q, k, v, logf, i, scale=scale)
    assert out.dtype == dtype and out.shape == (bh, s, dv)
    err = (out.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        assert err < 1e-3
    else:
        assert err < 3e-2 * max(1.0, want.float().abs().max().item())


def test_scan_kernel_matches_recurrence(cuda):
    q, k, v, logf, i = _scan_inputs(2, 100, 32, 64, torch.float32, cuda)
    out = kscan.mlstm_scan(q, k, v, logf, i)
    want = ref.mlstm_scan_ref(q, k, v, logf, i)
    assert (out - want).abs().max().item() < 1e-3


def _scan_close(out, want):
    tol = 3e-2 * max(1.0, want.float().abs().max().item())
    return (out.float() - want.float()).abs().max().item() < tol


@pytest.mark.parametrize("bh,s,dk,dv,scale", [
    (32, 256, 512, 512, None),       # admission: single pass by plan
    (4, 500, 512, 512, None),        # bulk prefill: chunk-parallel by plan
    (200, 256, 16, 64, 1.0),         # hymba's SSD heads
    (2, 129, 128, 64, None),
    (3, 37, 32, 96, None),           # one chunk
])
def test_scan_kernel_plans_agree(cuda, bh, s, dk, dv, scale):
    """The single pass and the chunk-parallel design, each forced, against
    each other and the plain version in bfloat16; one launch counted a
    call whatever runs."""
    q, k, v, logf, i = _scan_inputs(bh, s, dk, dv, torch.bfloat16, cuda)
    outs = {}
    for design in ("single", "chunk_parallel"):
        n = kscan.launches.count
        outs[design] = kscan.mlstm_scan(q, k, v, logf, i, scale=scale,
                                        design=design)
        torch.cuda.synchronize()
        assert kscan.launches.count == n + 1
    want = ref.mlstm_chunkwise_ref(q, k, v, logf, i, scale=scale)
    assert _scan_close(outs["single"], outs["chunk_parallel"])
    assert _scan_close(outs["single"], want)
    assert _scan_close(outs["chunk_parallel"], want)


@pytest.mark.parametrize("design", ["single", "chunk_parallel"])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 129])
@pytest.mark.parametrize("dk,dv,scale", [(512, 512, None), (16, 64, 1.0)])
def test_scan_kernel_chunk_edges(cuda, design, s, dk, dv, scale):
    q, k, v, logf, i = _scan_inputs(2, s, dk, dv, torch.bfloat16, cuda)
    out = kscan.mlstm_scan(q, k, v, logf, i, scale=scale, design=design)
    torch.cuda.synchronize()
    assert out.shape == (2, s, dv)
    assert _scan_close(out, ref.mlstm_chunkwise_ref(q, k, v, logf, i,
                                                    scale=scale))


@pytest.mark.parametrize("design", ["single", "chunk_parallel"])
def test_scan_kernel_gates_at_their_extremes(cuda, design):
    """i = 0 everywhere leaves the state at 0 and every output exactly 0;
    logf far below 0 forgets everything but the step itself."""
    q, k, v, logf, i = _scan_inputs(4, 200, 512, 512, torch.bfloat16, cuda)
    out = kscan.mlstm_scan(q, k, v, logf, torch.zeros_like(i), design=design)
    torch.cuda.synchronize()
    assert (out == 0).all()
    far = torch.full_like(logf, -1e4)
    out = kscan.mlstm_scan(q, k, v, far, i, design=design)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert _scan_close(out, ref.mlstm_chunkwise_ref(q, k, v, far, i))


@pytest.mark.parametrize("design", ["single", "chunk_parallel"])
@pytest.mark.parametrize("bh,s,dk,dv", [(4, 500, 512, 512),
                                        (16, 2048, 512, 512),
                                        (50, 2048, 16, 64)])
def test_scan_kernel_is_deterministic(cuda, design, bh, s, dk, dv):
    q, k, v, logf, i = _scan_inputs(bh, s, dk, dv, torch.bfloat16, cuda)
    first = kscan.mlstm_scan(q, k, v, logf, i, design=design)
    second = kscan.mlstm_scan(q, k, v, logf, i, design=design)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_scan_kernel_float32_keeps_its_precision_at_ssd_decays(cuda):
    """hymba's SSD gates (decay up to e^-5 a step, input weights up to 5,
    scale 1.0): kernel (chunks of 64) and plain version (chunks of 256)
    both take the decay between two steps from float64 sums, and agree to
    5e-5 where outputs reach 20 and more; with float32 sums the plain
    version misses that bound (tests/test_torch_ssm.py)."""
    bh, s = 200, 512
    q, k = (_randn((bh, s, 16), torch.float32, cuda, 40 + j) for j in range(2))
    v = _randn((bh, s, 64), torch.float32, cuda, 42)
    dt = torch.nn.functional.softplus(
        _randn((bh, s), torch.float32, cuda, 43) * 1.5)
    want = ref.mlstm_chunkwise_ref(q, k, v, -dt, dt, scale=1.0, chunk=256)
    got = kscan.mlstm_scan(q, k, v, -dt, dt, scale=1.0)
    torch.cuda.synchronize()
    assert want.abs().max() > 20
    assert (got - want).abs().max().item() < 5e-5


def test_scan_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, logf, i = _scan_inputs(2, 64, 12, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        kscan.mlstm_scan(q, k, v, logf, i)
    q, k, v, logf, i = _scan_inputs(2, 64, 32, 32, torch.float32, cuda)
    with pytest.raises(ValueError, match="float32"):
        kscan.mlstm_scan(q, k, v, logf, i, design="chunk_parallel")


# K3's bf16 single pass (``mlstm_tma_kernel``) against its plain version and
# against ``ref.mlstm_single_pass_ref``, the emulation of its roundings and
# sum order: the kernel differs from the emulation only by the order of the
# sums inside a tensor-core product and the device's exp, which move an
# output by a few of its bf16 spacings at most (SCAN_EMULATION_TOL of max(1,
# max |emulation|)), against the plain version's 3e-2.
SCAN_EMULATION_TOL = 1e-2
SCAN_SHAPES = [
    # bh, s, dk, dv, scale
    (16, 2048, 512, 512, None),      # xlstm-350m training, B 4 x H 4
    (50, 2048, 16, 64, 1.0),         # hymba-1.5b's SSD heads, training
    (32, 256, 512, 512, None),       # xlstm admission, B 8
    (4, 500, 512, 512, None),        # xlstm bulk prefill, B 1
    (200, 256, 16, 64, 1.0),         # hymba admission
    (3, 129, 96, 64, None),          # two consumers, a ragged panel
]


@pytest.mark.parametrize("design", ["single", "chunk_parallel"])
@pytest.mark.parametrize("bh,s,dk,dv,scale", SCAN_SHAPES)
def test_scan_kernel_at_the_path_shapes_matches_plain_and_emulation(
        cuda, design, bh, s, dk, dv, scale):
    q, k, v, logf, i = _scan_inputs(bh, s, dk, dv, torch.bfloat16, cuda)
    out = kscan.mlstm_scan(q, k, v, logf, i, scale=scale, design=design)
    torch.cuda.synchronize()
    want = ref.mlstm_chunkwise_ref(q, k, v, logf, i, scale=scale)
    err = (out.float() - want.float()).abs().max().item()
    assert err < 3e-2 * max(1.0, want.float().abs().max().item()), err
    if design == "single":
        emu = ref.mlstm_single_pass_ref(q, k, v, logf, i, scale=scale).float()
        err = (out.float() - emu).abs().max().item()
        assert err < SCAN_EMULATION_TOL * max(1.0, emu.abs().max().item()), err


def test_scan_single_pass_runs_the_tma_kernel(cuda):
    """bf16's single pass is the normaliser's pre-pass and
    ``mlstm_tma_kernel`` (one launch counted a call), the chunk-parallel
    plan the LOCAL, carry and OUTPUT launches, float32 the CUDA-core
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def names(dtype, design):
        q, k, v, logf, i = _scan_inputs(4, 300, 512, 512, dtype, cuda)
        kscan.mlstm_scan(q, k, v, logf, i, design=design)
        torch.cuda.synchronize()
        for _ in range(3):   # the profiler can lose a window's device events
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                kscan.mlstm_scan(q, k, v, logf, i, design=design)
                torch.cuda.synchronize()
            seen = [e.key for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.count
                    and "mlstm_" in e.key]
            if seen:
                return seen
        return seen
    single = sorted(names(torch.bfloat16, "single"))
    assert (len(single) == 2 and "mlstm_norm_kernel" in single[0]
            and "mlstm_tma_kernel" in single[1]), single
    parallel = names(torch.bfloat16, "chunk_parallel")
    assert len(parallel) == 3 and not any("tma" in n for n in parallel)
    f32 = names(torch.float32, None)
    assert len(f32) == 1 and "mlstm_kernel" in f32[0], f32


@pytest.mark.parametrize("bh,s,dk,dv,scale", [
    (16, 2048, 512, 512, None), (200, 256, 16, 64, 1.0), (3, 129, 96, 64, None)])
def test_scan_watchdog_build_gives_the_production_bits(cuda, bh, s, dk, dv,
                                                       scale):
    """The single pass on its watchdog build (-DREPRO_MBAR_WATCHDOG: every
    mbarrier wait traps after a bounded number of tries) runs the same
    arithmetic: the production build's bits, one watchdog launch
    counted and none of the production's."""
    q, k, v, logf, i = _scan_inputs(bh, s, dk, dv, torch.bfloat16, cuda)
    prod = kscan.mlstm_scan(q, k, v, logf, i, scale=scale, design="single")
    n, w = kscan.launches.count, kscan.watchdog_launches.count
    got = kscan.mlstm_scan_watchdog(q, k, v, logf, i, scale=scale,
                                    design="single")
    torch.cuda.synchronize()
    assert (kscan.launches.count, kscan.watchdog_launches.count) == (n, w + 1)
    assert torch.equal(got, prod)


def test_scan_kernels_build_without_spill_or_trap(cuda, tmp_path,
                                                  monkeypatch):
    """ptxas reports no spill in the forward's library, the single pass
    (at every panel count) and the chunk-parallel kernels hold tensor-core
    instructions, the production build's SASS holds no trap and ptxas
    keeps its register split; the watchdog build holds a trap."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    got = build.build(("mlstm_scan",),
                      extra=(("mlstm_scan", kscan.WATCHDOG_FLAGS),))
    path, _, log_ = got["mlstm_scan"]
    assert not [ln for ln in log_.splitlines()
                if re.search(r"[1-9]\d* bytes spill", ln)], log_
    assert not [ln for ln in log_.splitlines()
                if "setmaxnreg" in ln.lower() or "serializ" in ln.lower()]
    hgmma = build.sass_counts(path, "HGMMA")
    tma = {n: c for n, c in hgmma.items() if "mlstm_tma_kernel" in n}
    assert len(tma) == 4 and all(tma.values()), hgmma
    assert all(c for n, c in hgmma.items() if "mlstm_wgmma_kernel" in n)
    assert not any(build.sass_counts(path, "TRAP").values())
    watch = got["mlstm_scan " + " ".join(kscan.WATCHDOG_FLAGS)][0]
    assert any(c for n, c in build.sass_counts(watch, "TRAP").items()
               if "mlstm_tma_kernel" in n)


# K2's bf16 kernel on a build made to spill (-DREPRO_DECODE_SPILL: launch
# bounds that leave too few registers): it gave wrong bits or faulted while
# the split ranges were a 64-bit division; with the ranges in 32 bits it is
# held to the same gate as the production build, at G 1, 8 and 16 and 1 to
# 16 clusters a (row, KV head).
DECODE_SPILL_SHAPES = [
    # b, s, h, kh, hd
    (8, 1024, 16, 16, 128),     # qwen2-moe-a2.7b, G 1, one block a pair
    (4, 1024, 32, 4, 64),       # G 8, clusters of 8
    (6, 512, 32, 2, 64),        # G 16
    (8, 1024, 16, 2, 128),      # G 8, hd 128
    (1, 8192, 8, 1, 64),        # G 8, 16 clusters of 8
    (1, 4096, 16, 1, 128),      # G 16, hd 128, several clusters
]


def test_decode_spill_build_spills(cuda, tmp_path, monkeypatch):
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    _, _, log_ = build.build(("decode_attention",),
                             kdecode.SPILL_FLAGS)["decode_attention"]
    spills = [ln for ln in log_.splitlines()
              if re.search(r"[1-9]\d* bytes spill", ln)]
    assert spills, log_


@pytest.mark.parametrize("b,s,h,kh,hd", DECODE_SPILL_SHAPES)
def test_decode_spill_build_matches_plain(cuda, b, s, h, kh, hd):
    q = _randn((b, 1, h, hd), torch.bfloat16, cuda, 60)
    k = _randn((b, s, kh, hd), torch.bfloat16, cuda, 61)
    v = _randn((b, s, kh, hd), torch.bfloat16, cuda, 62)
    lens = torch.tensor(_edge_lengths(s, b, kh, torch.bfloat16),
                        dtype=torch.int32, device=cuda)
    n, w = kdecode.launches.count, kdecode.spill_launches.count
    out = kdecode.decode_attention_spill(q, k, v, lens)
    again = kdecode.decode_attention_spill(q, k, v, lens)
    torch.cuda.synchronize()
    assert (kdecode.launches.count, kdecode.spill_launches.count) == (n, w + 2)
    _decode_check(out, q, k, v, lens, torch.bfloat16)
    assert torch.equal(out, again)
    assert torch.equal(out, kdecode.decode_attention(q, k, v, lens))


# K2's bf16 kernel against ``ref.grouped_decode_mma_ref``, the emulation of
# its splits, tiles, bf16 P and merge order: only the order of the sums
# inside an mma and the device's exp2 differ, a few bf16 spacings of the
# output at most.
DECODE_EMULATION_TOL = 1e-2


@pytest.mark.parametrize("b,s,h,kh,hd", [
    (8, 1024, 32, 8, 64),       # llama3.2-1b
    (8, 1024, 25, 5, 64),       # hymba-1.5b
    (8, 1024, 16, 16, 128),     # qwen2-moe-a2.7b
    (8, 1024, 32, 32, 80),      # stablelm-3b
    (1, 8192, 8, 1, 64),        # clusters in groups
])
def test_decode_mma_kernel_matches_its_emulation(cuda, b, s, h, kh, hd):
    q = _randn((b, 1, h, hd), torch.bfloat16, cuda, 63)
    k = _randn((b, s, kh, hd), torch.bfloat16, cuda, 64)
    v = _randn((b, s, kh, hd), torch.bfloat16, cuda, 65)
    lens = torch.tensor(_edge_lengths(s, b, kh, torch.bfloat16),
                        dtype=torch.int32, device=cuda)
    out = kdecode.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    cluster, groups = kdecode.mma_plan(s, b, kh)
    emu = ref.grouped_decode_mma_ref(q, k, v, lens,
                                     n_split=cluster * groups).float()
    err = (out.float() - emu).abs().max().item()
    assert err < DECODE_EMULATION_TOL * max(1.0, emu.abs().max().item()), err


# ------------------------------------------------------------ K1 backward
BWD_SHAPES = [
    # b, sq, sk, h, kh, hd, causal, window
    (2, 256, 256, 32, 8, 64, True, 0),      # llama3.2-1b training, G = 4
    (1, 300, 300, 8, 8, 128, True, 0),      # hd 128, G = 1, ragged
    (2, 200, 200, 4, 2, 64, True, 8),       # window 8
    (2, 130, 130, 4, 2, 32, False, 0),      # unmasked, ragged
    (2, 70, 200, 4, 2, 64, True, 0),        # Sq < Sk, causal
    (2, 70, 200, 4, 1, 16, False, 0),       # Sq < Sk, unmasked, G = 4
    (1, 200, 200, 4, 4, 80, True, 50),      # hd 80, window
    (2, 100, 60, 2, 1, 32, True, 0),        # Sq > Sk: rows that see no key
    # the bf16 kernels' tile edges: 128-key dK/dV blocks, 64-query tiles
    # of their ring, 128-query dQ blocks, 64-key tiles of the dQ ring
    (1, 129, 129, 4, 2, 64, True, 0),       # Sk = 129: one past a key block
    (1, 257, 257, 4, 1, 128, True, 0),      # Sk = 257, hd 128, G = 4
    (2, 65, 65, 4, 2, 64, False, 0),        # Sq = 65: one past a query tile
    (1, 65, 257, 4, 2, 32, True, 0),        # Sq = 65 < Sk = 257, causal
    (1, 300, 300, 4, 2, 64, True, 100),     # window ends inside a tile
    (1, 257, 257, 4, 4, 80, False, 0),      # hd 80 (padded), unmasked
    (1, 129, 129, 2, 1, 16, True, 40),      # hd 16, window, G = 2
    (1, 1024, 1024, 16, 4, 64, True, 0),    # G = 4 at S = 1024
    # work tiles that no key or query reaches (their gradients stored as
    # zeros, nothing loaded): query blocks before the first key (Sq > Sk,
    # causal), and a key block older than every query's window
    (1, 300, 40, 4, 2, 64, True, 0),
    (1, 64, 300, 4, 2, 64, True, 16),
]


def _bwd_inputs(b, sq, sk, h, kh, hd, dtype, cuda, seed=60):
    q = _randn((b, sq, h, hd), dtype, cuda, seed)
    k = _randn((b, sk, kh, hd), dtype, cuda, seed + 1)
    v = _randn((b, sk, kh, hd), dtype, cuda, seed + 2)
    do = _randn((b, sq, h, hd), dtype, cuda, seed + 3)
    return q, k, v, do


def _rel_err(got, want) -> float:
    want = want.float()
    return ((got.float() - want).abs().max()
            / max(1.0, want.abs().max().item())).item()


# ||got - plain|| / ||plain||: fails when a part of a gradient is wrong,
# however small its entries are beside max(1, max |plain|).
NORM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _norm_err(got, want) -> float:
    want = want.float()
    return ((got.float() - want).norm() / want.norm()).item()


def _norm_err_or_zero(got, want) -> float:
    """``_norm_err``; where the plain gradient is exactly 0 (a router with
    k = 1, whose weight is always 1; dlogf at one step), 0 if the kernel's
    is exactly 0 too, else inf."""
    if want.float().norm() == 0:
        return 0.0 if (got.float() == 0).all() else float("inf")
    return _norm_err(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kh,hd,causal,window", BWD_SHAPES)
def test_flash_backward_kernel_matches_plain(cuda, dtype, b, sq, sk, h, kh,
                                             hd, causal, window):
    q, k, v, do = _bwd_inputs(b, sq, sk, h, kh, hd, dtype, cuda)
    n = kflash.bwd_launches.count
    o, lse = kflash.flash_attention(q, k, v, causal=causal, window=window,
                                    return_lse=True)
    want_o, want_lse = ref.grouped_flash_ref(q, k, v, causal=causal,
                                             window=window, return_lse=True)
    got = kflash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                     window=window)
    torch.cuda.synchronize()
    assert kflash.bwd_launches.count == n + 1
    want = ref.grouped_flash_bwd_ref(q, k, v, want_o, want_lse, do,
                                     causal=causal, window=window)
    live = torch.isfinite(want_lse)
    assert torch.equal(live, torch.isfinite(lse))
    lse_err = (lse[live] - want_lse[live]).abs().max().item()
    assert lse_err < (1e-5 if dtype == torch.float32 else 1e-4)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert _rel_err(g, w) < TOL[dtype], (name, _rel_err(g, w))
        assert _norm_err(g, w) < NORM_TOL[dtype], (name, _norm_err(g, w))


def test_flash_backward_is_deterministic_and_takes_strided_grads(cuda):
    q, k, v, do = _bwd_inputs(2, 300, 300, 8, 2, 64, torch.bfloat16, cuda)
    o, lse = kflash.flash_attention(q, k, v, return_lse=True)
    a = kflash.flash_attention_bwd(q, k, v, o, lse, do)
    strided = do.transpose(1, 2).contiguous().transpose(1, 2)   # not contiguous
    b = kflash.flash_attention_bwd(q, k, v, o, lse, strided)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("hd,dv,kh", [(64, 64, 4), (128, 128, 16),
                                       (192, 128, 16)])
def test_flash_backward_watchdog_build_gives_the_production_bits(cuda, hd,
                                                                 dv, kh):
    """The backward's watchdog build (``-DREPRO_MBAR_WATCHDOG``: every
    mbarrier wait traps after a bounded number of tries) against the plain
    version at the bf16 gates, over more work tiles than SMs, and bit for
    bit the production build's gradients; its launches count apart."""
    dt, b, s, h = torch.bfloat16, 2, 1000, 16
    q, k = _randn((b, s, h, hd), dt, cuda, 64), _randn((b, s, kh, hd), dt,
                                                        cuda, 65)
    v = _randn((b, s, kh, dv), dt, cuda, 66)
    do = _randn((b, s, h, dv), dt, cuda, 67)
    scale = hd ** -0.5
    o, lse = kflash.flash_attention(q, k, v, scale=scale, return_lse=True)
    n, w = kflash.bwd_launches.count, kflash.bwd_watchdog_launches.count
    got = kflash.flash_attention_bwd_watchdog(q, k, v, o, lse, do, scale=scale)
    torch.cuda.synchronize()
    assert (kflash.bwd_launches.count, kflash.bwd_watchdog_launches.count) \
        == (n, w + 1)
    po, plse = ref.grouped_flash_ref(q, k, v, scale=scale, return_lse=True)
    want = ref.grouped_flash_bwd_ref(q, k, v, po, plse, do, scale=scale)
    for name, g, wnt in zip("qkv", got, want):
        assert _rel_err(g, wnt) < TOL[dt], (name, _rel_err(g, wnt))
        assert _norm_err(g, wnt) < NORM_TOL[dt], (name, _norm_err(g, wnt))
    prod = kflash.flash_attention_bwd(q, k, v, o, lse, do, scale=scale)
    assert all(torch.equal(x, y) for x, y in zip(got, prod))


def test_flash_backward_copies_what_no_tensor_map_describes(cuda):
    """bf16 K and V expanded over their heads (stride 0) and q one element
    into its storage are copied before the tensor maps are encoded, each
    counted in ``tma_copies``; dO as a transposed view is read as it is (a
    map describes it).  The gradients equal those of packed copies of the
    same inputs, bit for bit."""
    dt, b, s, h, kh, hd = torch.bfloat16, 2, 300, 8, 2, 64
    q = _randn((b * s * h * hd + 1,), dt, cuda, 68)[1:].view(b, s, h, hd)
    k = _randn((b, s, 1, hd), dt, cuda, 69).expand(b, s, kh, hd)
    v = _randn((b, s, 1, hd), dt, cuda, 70).expand(b, s, kh, hd)
    do = _randn((b, h, s, hd), dt, cuda, 71).transpose(1, 2)
    o, lse = kflash.flash_attention(q, k, v, return_lse=True)
    c, n = kflash.tma_copies.count, kflash.bwd_launches.count
    got = kflash.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert kflash.tma_copies.count == c + 3
    assert kflash.bwd_launches.count == n + 1
    packed = [t.contiguous() for t in (q, k, v, do)]
    want = kflash.flash_attention_bwd(*packed[:3], o, lse, packed[3])
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def _bwd_kernel_names(call, expect: int = 3) -> set:
    """Names of the device kernels ``call`` launches whose name holds
    ``bwd_``, from ``torch.profiler`` over two calls after one outside the
    window: up to three windows until one holds ``expect``, as the
    profiler can drop device events, the first launches of a window most
    (K1's backward launches three kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            call()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and "bwd_" in e.key}
        if len(names) >= expect:
            break
    return names


@pytest.mark.parametrize("hd", kflash.HEAD_DIMS)
def test_flash_backward_launches_the_kernels_of_its_input_type(cuda, hd):
    """bfloat16 runs dK/dV and dQ on the tensor cores (the warp-specialised
    TMA kernels), float32 on the CUDA cores; both start with D's kernel."""
    launched = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = _bwd_inputs(1, 130, 130, 4, 2, hd, dtype, cuda)
        o, lse = kflash.flash_attention(q, k, v, return_lse=True)
        launched[dtype] = _bwd_kernel_names(
            lambda: kflash.flash_attention_bwd(q, k, v, o, lse, do))
    for dtype, names in launched.items():
        tma = {n for n in names if "_tma_kernel" in n}
        assert len(names) == 3, (dtype, names)
        assert sum("bwd_delta_kernel" in n for n in names) == 1, names
        if dtype == torch.bfloat16:
            assert (sum("flash_bwd_dkdv_tma_kernel" in n for n in tma),
                    sum("flash_bwd_dq_tma_kernel" in n for n in tma)) == (
                1, 1), names
        else:
            assert not tma, names
            assert (sum("bwd_dkdv_kernel" in n for n in names),
                    sum("bwd_dq_kernel" in n for n in names)) == (1, 1), names


def test_flash_backward_at_mla_dims_launches_the_kernels_of_its_input_type(
        cuda):
    """MLA's (192, 128): bfloat16 runs the TMA kernels (dV and dK work
    tiles apart inside one dK/dV launch), float32 the CUDA-core ones."""
    for dtype in (torch.float32, torch.bfloat16):
        q = _randn((1, 130, 4, 192), dtype, cuda, 74)
        k = _randn((1, 130, 4, 192), dtype, cuda, 75)
        v = _randn((1, 130, 4, 128), dtype, cuda, 76)
        do = _randn((1, 130, 4, 128), dtype, cuda, 77)
        o, lse = kflash.flash_attention(q, k, v, return_lse=True)
        names = _bwd_kernel_names(
            lambda: kflash.flash_attention_bwd(q, k, v, o, lse, do))
        assert len(names) == 3, (dtype, names)
        assert sum("bwd_delta_kernel" in n for n in names) == 1, names
        tma = (sum("flash_bwd_dkdv_tma_kernel<192, 128>" in n
                   for n in names),
               sum("flash_bwd_dq_tma_kernel<192, 128>" in n
                   for n in names))
        cuda_cores = (sum("bwd_dkdv_kernel<192, 128>" in n for n in names),
                      sum("bwd_dq_kernel<192, 128>" in n for n in names))
        if dtype == torch.bfloat16:
            assert tma == (1, 1) and cuda_cores == (0, 0), names
        else:
            assert tma == (0, 0) and cuda_cores == (1, 1), names


def test_grouped_flash_gradient_runs_the_kernels_not_the_plain_version(
        cuda, monkeypatch):
    q, k, v, do = _bwd_inputs(2, 200, 200, 8, 2, 64, torch.float32, cuda)
    o, lse = ref.grouped_flash_ref(q, k, v, window=40, return_lse=True)
    want = ref.grouped_flash_bwd_ref(q, k, v, o, lse, do, window=40)

    def refuse(*a, **kw):
        raise AssertionError("the plain version ran on the card")
    monkeypatch.setattr(ref, "grouped_flash_ref", refuse)
    monkeypatch.setattr(ref, "grouped_flash_bwd_ref", refuse)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    n_fwd, n_bwd = kflash.launches.count, kflash.bwd_launches.count
    out = ops.grouped_flash(qg, kg, vg, window=40)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    assert (kflash.launches.count, kflash.bwd_launches.count) == (
        n_fwd + 1, n_bwd + 1)
    for g, w in zip(got, want):
        assert _rel_err(g, w) < TOL[torch.float32]
    with torch.no_grad():                   # no gradient: the plain call
        ops.grouped_flash(qg, kg, vg, window=40)
    assert kflash.bwd_launches.count == n_bwd + 1


def test_kernels_without_a_backward_refuse_gradients(cuda):
    """Every kernel on a training path has its backward now: K3's and K4's
    gradients on the card launch their backward kernels; what K1's
    backward does not take (unequal dims other than MLA's) is refused
    before a launch."""
    logits = _randn((8, 64), torch.float32, cuda, 5).requires_grad_(True)
    n = kmoe.bwd_launches.count
    r = ops.moe_route(logits, 4, capacity=2)
    torch.autograd.grad(r.weights.sum() + r.prob_sum.sum(), logits)
    assert kmoe.bwd_launches.count == n + 1
    q, k, v, logf, i = _scan_inputs(2, 64, 32, 32, torch.float32, cuda)
    n = kscan.bwd_launches.count
    q = q.requires_grad_(True)
    torch.autograd.grad(ops.mlstm_scan(q, k, v, logf, i).sum(), q)
    assert kscan.bwd_launches.count == n + 1
    q = torch.zeros((1, 8, 4, 192), device=cuda, dtype=torch.bfloat16)
    v = torch.zeros((1, 8, 4, 64), device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros((1, 4, 8), device=cuda)
    n = kflash.bwd_launches.count
    with pytest.raises(ValueError, match="head dims"):
        kflash.flash_attention_bwd(q, q, v, q[..., :64], lse, q[..., :64])
    assert kflash.bwd_launches.count == n


def test_train_loss_gradient_on_the_card_matches_plain_path(cuda, monkeypatch):
    """The reduced llama in float32 on the card: loss and every gradient
    leaf through K1 and its backward against the plain path, 1e-4 of the
    leaf's own max |plain|."""
    from repro_torch.models.transformer import Model
    from repro_torch.models.weights import tree_leaves
    from repro_torch.training import trainer
    model = Model(get_arch("llama3.2-1b").reduced(), device="cuda")
    params = model.init_params(seed=3)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 96),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks.to(cuda), "labels": toks.to(cuda)}
    n = kflash.bwd_launches.count
    loss, grads = trainer.value_and_grad(model, params, batch)
    assert kflash.bwd_launches.count == n + model.cfg.n_layers
    monkeypatch.setattr(ops, "grouped_flash", ref.grouped_flash_ref)
    ploss, pgrads = trainer.value_and_grad(model, params, batch)
    assert abs(loss.item() - ploss.item()) < 1e-4
    for g, w in zip(tree_leaves(grads), tree_leaves(pgrads)):
        assert ((g - w).abs().max() / w.abs().max()).item() < 1e-4


# ------------------------------------- K1 backward at MLA's (192, 128)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,causal", [
    (2, 256, 256, 16, True),        # deepseek-v3 training: every head its own
    (1, 300, 300, 8, True),         # ragged
    (2, 70, 200, 4, True),          # Sq < Sk
    (1, 129, 129, 4, False),        # unmasked, one past a tile
])
def test_flash_backward_at_mla_dims_matches_plain(cuda, dtype, b, sq, sk, h,
                                                  causal):
    q = _randn((b, sq, h, 192), dtype, cuda, 70)
    k = _randn((b, sk, h, 192), dtype, cuda, 71)
    v = _randn((b, sk, h, 128), dtype, cuda, 72)
    do = _randn((b, sq, h, 128), dtype, cuda, 73)
    scale = 192 ** -0.5
    o, lse = kflash.flash_attention(q, k, v, causal=causal, scale=scale,
                                    return_lse=True)
    want_o, want_lse = ref.grouped_flash_ref(q, k, v, causal=causal,
                                             scale=scale, return_lse=True)
    n = kflash.bwd_launches.count
    got = kflash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                     scale=scale)
    torch.cuda.synchronize()
    assert kflash.bwd_launches.count == n + 1
    want = ref.grouped_flash_bwd_ref(q, k, v, want_o, want_lse, do,
                                     causal=causal, scale=scale)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert _rel_err(g, w) < TOL[dtype], (name, _rel_err(g, w))
        assert _norm_err(g, w) < NORM_TOL[dtype], (name, _norm_err(g, w))
    again = kflash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                       scale=scale)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


# ------------------------------------------------------------ K3 backward
SCAN_BWD_SHAPES = [
    # bh, s, dk, dv, scale, qk: q and k scaled so that some rows have
    # |a| > 1 and others not (both branches of the normaliser)
    (4, 256, 512, 512, None, 2.0),   # xlstm-350m heads
    (2, 150, 512, 512, None, 2.0),   # ragged S
    (50, 256, 16, 64, 1.0, 1.0),     # hymba's SSD heads, scale 1.0
    (3, 37, 16, 64, 1.0, 1.0),       # S below one chunk
    (3, 130, 32, 96, None, 1.5),     # dv not a multiple of 64
    # one step; q, k small: with |a| > 1 a single step gives h = sign(a) v,
    # whose dq and dk are exactly 0, and both sides only rounding noise
    (2, 1, 64, 64, None, 0.5),
]


def _scan_bwd_inputs(bh, s, dk, dv, qk, dtype, device, ssd):
    q = (_randn((bh, s, dk), torch.float32, device, 80) * qk).to(dtype)
    k = (_randn((bh, s, dk), torch.float32, device, 81) * qk).to(dtype)
    v = _randn((bh, s, dv), dtype, device, 82)
    dh = _randn((bh, s, dv), dtype, device, 83)
    g = _randn((bh, s), torch.float32, device, 84)
    if ssd:
        dt = torch.nn.functional.softplus(g * 1.5)
        return q, k, v, -dt, dt, dh
    return (q, k, v, torch.nn.functional.logsigmoid(g + 2.0),
            torch.sigmoid(_randn((bh, s), torch.float32, device, 85)), dh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,dk,dv,scale,qk", SCAN_BWD_SHAPES)
def test_scan_backward_kernel_matches_plain(cuda, dtype, bh, s, dk, dv, scale,
                                            qk):
    q, k, v, logf, i, dh = _scan_bwd_inputs(bh, s, dk, dv, qk, dtype, cuda,
                                            ssd=scale == 1.0)
    n = kscan.bwd_launches.count
    got = kscan.mlstm_scan_bwd(q, k, v, logf, i, dh, scale=scale)
    torch.cuda.synchronize()
    assert kscan.bwd_launches.count == n + 1
    want = ref.mlstm_chunkwise_bwd_ref(q, k, v, logf, i, dh, scale=scale)
    for name, g, w in zip(("dq", "dk", "dv", "dlogf", "di"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g.float()).all(), name
        assert _rel_err(g, w) < TOL[dtype], (name, _rel_err(g, w))
        err = _norm_err_or_zero(g, w)
        assert err < NORM_TOL[dtype], (name, err)
    again = kscan.mlstm_scan_bwd(q, k, v, logf, i, dh, scale=scale)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_scan_backward_builds_without_spill(cuda, tmp_path, monkeypatch):
    """ptxas reports no spill in any kernel of K3's backward, the float32
    CUDA-core kernels and the bf16 tensor-core ones alike (dk up to 512
    changes no register count: the tiles are 64 x 64 whatever dk is), and
    the warp-specialised kernels keep their register split: no wgmma
    serialised or waited on by ptxas, no setmaxnreg dropped."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    _, _, log_ = build.build(("mlstm_scan_bwd",))["mlstm_scan_bwd"]
    for name in ("scan_bwd_grad_kernel", "scan_bwd_walk_tma_kernel",
                 "scan_bwd_norm_wgmma_kernel", "scan_bwd_grad_tma_kernel",
                 "scan_bwd_gates_warp_kernel", "scan_bwd_final_kernel"):
        assert name in log_, name
    assert not [ln for ln in log_.splitlines()
                if re.search(r"[1-9]\d* bytes spill", ln)], log_
    assert not [ln for ln in log_.splitlines()
                if "serializ" in ln.lower() or "setmaxnreg" in ln.lower()
                or "warpgroup.wait is injected" in ln], log_


def test_scan_backward_production_build_holds_no_trap(cuda, tmp_path,
                                                      monkeypatch):
    """No kernel of K3's backward's production build can trap (a trap
    makes ptxas ignore setmaxnreg); its watchdog build's mbarrier waits
    can (``BPT.TRAP`` in the SASS)."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    built = build.build(("mlstm_scan_bwd",),
                        extra=(("mlstm_scan_bwd", kscan.WATCHDOG_FLAGS),))
    traps = {key: sum(build.sass_counts(path, "TRAP").values())
             for key, (path, _, _) in built.items()}
    assert traps["mlstm_scan_bwd"] == 0, traps
    assert traps["mlstm_scan_bwd -DREPRO_MBAR_WATCHDOG"] > 0, traps


# Spill stores K1's bf16 backward kernels may have, as the design notes in
# csrc/flash_attention_bwd.cu state them: none, at every pair of dims (a
# consumer warpgroup holds 240 registers by setmaxnreg).
BWD_SPILL_STORES = {}


def test_flash_backward_wgmma_kernels_spill_no_more_than_stated(
        cuda, tmp_path, monkeypatch):
    """ptxas's spill stores of each bf16 backward kernel (the warp-
    specialised dK/dV and dQ kernels, each on ``wgmma``) at each pair of
    dims, against ``BWD_SPILL_STORES``; and no role's setmaxnreg dropped
    nor wgmma serialised."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    _, _, log_ = build.build(("flash_attention_bwd",))["flash_attention_bwd"]
    spills, name = {}, None
    for ln in log_.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"flash_bwd_\w+?_tma_kernelILi\d+ELi\d+E", ln)
            name = m.group(0) if m else None
        elif name and (m := re.search(r"(\d+) bytes spill stores", ln)):
            spills[name] = int(m.group(1))
    assert len(spills) == 2 * (len(kflash.HEAD_DIMS) + len(kflash.DIM_PAIRS))
    over = {n: b for n, b in spills.items() if b > BWD_SPILL_STORES.get(n, 0)}
    assert not over, spills
    assert not [ln for ln in log_.splitlines()
                if "setmaxnreg" in ln.lower() or "serializ" in ln.lower()]


def test_scan_backward_launches_the_kernels_of_its_input_type(cuda):
    """bfloat16 runs K3's backward on the tensor cores (the gates a warp a
    chunk, the two state walks and the gradient kernel warp specialised on
    TMA, the normaliser on ``wgmma``, then the gate gradients' kernel);
    float32 keeps the CUDA-core kernels after the same gates' kernel."""
    bf16 = {"scan_bwd_gates_warp_kernel", "scan_bwd_walk_tma_kernel<1>",
            "scan_bwd_walk_tma_kernel<-1>", "scan_bwd_norm_wgmma_kernel",
            "scan_bwd_grad_tma_kernel", "scan_bwd_final_kernel"}
    f32 = {"scan_bwd_gates_warp_kernel", "scan_bwd_outer_kernel",
           "scan_bwd_carry_kernel", "scan_bwd_norm_kernel",
           "scan_bwd_grad_kernel"}
    for dtype, want in ((torch.bfloat16, bf16), (torch.float32, f32)):
        q, k, v, logf, i, dh = _scan_bwd_inputs(2, 200, 64, 64, 2.0, dtype,
                                                cuda, ssd=False)
        names = _bwd_kernel_names(
            lambda: kscan.mlstm_scan_bwd(q, k, v, logf, i, dh), len(want))
        short = {re.search(r"scan_bwd_\w+(?:<[^>]*>)?", n).group(0)
                 for n in names}
        assert short == want, (dtype, names)


# bh, s, dk, dv, scale, qk, ssd: the training shapes of xlstm-350m (B 4)
# and hymba-1.5b's SSD heads (B 2)
SCAN_TRAIN_SHAPES = [(16, 2048, 512, 512, None, 1.0, False),
                     (50, 2048, 16, 64, 1.0, 0.5, True)]


@pytest.mark.parametrize("bh,s,dk,dv,scale,qk,ssd", SCAN_TRAIN_SHAPES)
def test_scan_backward_at_training_shapes_matches_plain(cuda, bh, s, dk, dv,
                                                        scale, qk, ssd):
    q, k, v, logf, i, dh = _scan_bwd_inputs(bh, s, dk, dv, qk, torch.bfloat16,
                                            cuda, ssd=ssd)
    got = kscan.mlstm_scan_bwd(q, k, v, logf, i, dh, scale=scale)
    want = ref.mlstm_chunkwise_bwd_ref(q, k, v, logf, i, dh, scale=scale)
    for name, g, w in zip(("dq", "dk", "dv", "dlogf", "di"), got, want):
        assert _rel_err(g, w) < TOL[torch.bfloat16], (name, _rel_err(g, w))
        err = _norm_err_or_zero(g, w)
        assert err < NORM_TOL[torch.bfloat16], (name, err)
    again = kscan.mlstm_scan_bwd(q, k, v, logf, i, dh, scale=scale)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("bh,s,dk,dv,scale,qk", [
    (4, 256, 512, 512, None, 2.0), (50, 256, 16, 64, 1.0, 1.0),
    (3, 130, 32, 96, None, 1.5)])
def test_scan_backward_watchdog_build_gives_the_production_bits(
        cuda, bh, s, dk, dv, scale, qk):
    """K3's backward on its watchdog build (``-DREPRO_MBAR_WATCHDOG``:
    every mbarrier wait traps after a bounded number of tries) against the
    plain version at the bf16 gates, and bit for bit the production
    build's gradients; its launches count apart."""
    x = _scan_bwd_inputs(bh, s, dk, dv, qk, torch.bfloat16, cuda,
                         ssd=scale == 1.0)
    n, w = kscan.bwd_launches.count, kscan.bwd_watchdog_launches.count
    got = kscan.mlstm_scan_bwd_watchdog(*x, scale=scale)
    torch.cuda.synchronize()
    assert (kscan.bwd_launches.count, kscan.bwd_watchdog_launches.count) \
        == (n, w + 1)
    want = ref.mlstm_chunkwise_bwd_ref(*x, scale=scale)
    for name, g, wnt in zip(("dq", "dk", "dv", "dlogf", "di"), got, want):
        assert _rel_err(g, wnt) < TOL[torch.bfloat16], (name, _rel_err(g, wnt))
        err = _norm_err_or_zero(g, wnt)
        assert err < NORM_TOL[torch.bfloat16], (name, err)
    prod = kscan.mlstm_scan_bwd(*x, scale=scale)
    assert all(torch.equal(a, b) for a, b in zip(got, prod))


def test_scan_backward_copies_what_no_tensor_map_describes(cuda):
    """A bf16 dh that is not packed (a transposed view, as autograd may
    hand it on) is copied before the tensor maps are encoded and counted
    in ``tma_copies``; packed inputs are not.  The gradients equal those
    of the packed copy, bit for bit."""
    q, k, v, logf, i, dh = _scan_bwd_inputs(2, 200, 64, 64, 2.0,
                                            torch.bfloat16, cuda, ssd=False)
    strided = dh.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous()
    c = kscan.tma_copies.count
    a = kscan.mlstm_scan_bwd(q, k, v, logf, i, dh)
    assert kscan.tma_copies.count == c
    b = kscan.mlstm_scan_bwd(q, k, v, logf, i, strided)
    torch.cuda.synchronize()
    assert kscan.tma_copies.count == c + 1
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_backward_at_mla_training_shape_matches_plain(cuda):
    """deepseek-v3's training shape: B 1, S 2048, 128 heads, (192, 128),
    causal, bf16; two calls bit-identical."""
    dt = torch.bfloat16
    q, k = (_randn((1, 2048, 128, 192), dt, cuda, 90 + j) for j in range(2))
    v, do = (_randn((1, 2048, 128, 128), dt, cuda, 92 + j) for j in range(2))
    scale = 192 ** -0.5
    o, lse = kflash.flash_attention(q, k, v, scale=scale, return_lse=True)
    got = kflash.flash_attention_bwd(q, k, v, o, lse, do, scale=scale)
    po, plse = ref.grouped_flash_ref(q, k, v, scale=scale, return_lse=True)
    want = ref.grouped_flash_bwd_ref(q, k, v, po, plse, do, scale=scale)
    for name, g, w in zip("qkv", got, want):
        assert _rel_err(g, w) < TOL[dt], (name, _rel_err(g, w))
        assert _norm_err(g, w) < NORM_TOL[dt], (name, _norm_err(g, w))
    again = kflash.flash_attention_bwd(q, k, v, o, lse, do, scale=scale)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_scan_backward_refuses_what_it_does_not_take(cuda):
    """A bf16 call the tensor-core kernels do not take is refused before a
    launch: dk not a multiple of 8, dk past 512."""
    n = kscan.bwd_launches.count
    for dk in (12, 520):
        q, k, v, logf, i, dh = _scan_bwd_inputs(2, 64, dk, 64, 1.0,
                                                torch.bfloat16, cuda,
                                                ssd=False)
        with pytest.raises(ValueError, match="bfloat16"):
            kscan.mlstm_scan_bwd(q, k, v, logf, i, dh)
    assert kscan.bwd_launches.count == n


def test_scan_gradient_runs_the_kernels_not_the_plain_version(cuda,
                                                              monkeypatch):
    q, k, v, logf, i, dh = _scan_bwd_inputs(4, 200, 64, 64, 2.0,
                                            torch.float32, cuda, ssd=False)
    want = ref.mlstm_chunkwise_bwd_ref(q, k, v, logf, i, dh)

    def refuse(*a, **kw):
        raise AssertionError("the plain version ran on the card")
    monkeypatch.setattr(ref, "mlstm_chunkwise_ref", refuse)
    monkeypatch.setattr(ref, "mlstm_chunkwise_bwd_ref", refuse)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v, logf, i)]
    n_fwd, n_bwd = kscan.launches.count, kscan.bwd_launches.count
    got = torch.autograd.grad(ops.mlstm_scan(*xs), xs, dh)
    torch.cuda.synchronize()
    assert (kscan.launches.count, kscan.bwd_launches.count) == (
        n_fwd + 1, n_bwd + 1)
    for g, w in zip(got, want):
        assert _rel_err(g, w) < TOL[torch.float32]


# ------------------------------------------------------------ K4 backward
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,e,k,n_valid,scale", [
    (8, 64, 4, 60, 1.0), (4096, 64, 4, 60, 1.0), (2048, 256, 8, 256, 2.5),
    (37, 16, 1, 12, 1.0), (500, 8, 2, 8, 1.0)])
def test_router_backward_kernel_matches_plain(cuda, dtype, t, e, k, n_valid,
                                              scale):
    logits = _randn((t, e), dtype, cuda, 90)
    r = kmoe.moe_route(logits, k, capacity=max(1, t * k // e),
                       n_valid=n_valid, router_scale=scale)
    dw = _randn((t, k), torch.float32, cuda, 91)
    dps = _randn((e,), torch.float32, cuda, 92)
    for sums in (dps, None):
        n = kmoe.bwd_launches.count
        got = kmoe.moe_route_bwd(logits, r.idx, r.weights, dw, sums,
                                 n_valid=n_valid, router_scale=scale)
        torch.cuda.synchronize()
        assert kmoe.bwd_launches.count == n + 1
        want = ref.moe_route_bwd_ref(logits, r.idx, r.weights, dw, sums,
                                     n_valid=n_valid, router_scale=scale)
        assert got.dtype == dtype and got.shape == (t, e)
        assert (got[:, n_valid:] == 0).all()
        assert _rel_err(got, want) < TOL[dtype], _rel_err(got, want)
        err = _norm_err_or_zero(got, want)
        assert err < NORM_TOL[dtype], err
        again = kmoe.moe_route_bwd(logits, r.idx, r.weights, dw, sums,
                                   n_valid=n_valid, router_scale=scale)
        assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [8, 2048])
@pytest.mark.parametrize("e,k,n_valid,scale", [(64, 4, 60, 1.0),
                                               (256, 8, 256, 2.5)])
@pytest.mark.parametrize("pad", [0, 1])
def test_router_backward_at_training_shapes_is_bit_identical(
        cuda, dtype, t, e, k, n_valid, scale, pad):
    """K4's backward at qwen2-moe's (E 64, k 4) and deepseek's (E 256, k 8)
    training widths: against the plain gradient and bit-identical from
    call to call.  ``pad`` 1 gives rows one element longer than E, so the
    lanes take the scalar path in place of the vector loads."""
    wide = _randn((t, e + pad), dtype, cuda, 95)
    logits = wide[:, :e]
    r = kmoe.moe_route(logits, k, capacity=max(1, t * k // e),
                       n_valid=n_valid, router_scale=scale)
    dw = _randn((t, k), torch.float32, cuda, 96)
    dps = _randn((e,), torch.float32, cuda, 97)
    for sums in (dps, None):
        got = kmoe.moe_route_bwd(logits, r.idx, r.weights, dw, sums,
                                 n_valid=n_valid, router_scale=scale)
        want = ref.moe_route_bwd_ref(logits, r.idx, r.weights, dw, sums,
                                     n_valid=n_valid, router_scale=scale)
        assert (got[:, n_valid:] == 0).all()
        assert _rel_err(got, want) < TOL[dtype], _rel_err(got, want)
        assert _norm_err_or_zero(got, want) < NORM_TOL[dtype]
        for _ in range(3):
            assert torch.equal(got, kmoe.moe_route_bwd(
                logits, r.idx, r.weights, dw, sums, n_valid=n_valid,
                router_scale=scale))


def test_router_gradient_through_ops_runs_the_kernel(cuda):
    """``ops.moe_route`` and ``ops.moe_topk`` under autograd: one forward
    and one backward launch each, the gradient the plain one's."""
    logits = _randn((300, 64), torch.float32, cuda, 93)
    dw = _randn((300, 4), torch.float32, cuda, 94)
    lg = logits.clone().requires_grad_(True)
    n_fwd, n_bwd = kmoe.launches.count, kmoe.bwd_launches.count
    r = ops.moe_route(lg, 4, capacity=20, n_valid=60)
    got, = torch.autograd.grad((r.weights * dw).sum() + r.prob_sum.sum(), lg)
    w, idx = ops.moe_topk(lg, 4, n_valid=60)
    got_topk, = torch.autograd.grad((w * dw).sum(), lg)
    torch.cuda.synchronize()
    assert (kmoe.launches.count, kmoe.bwd_launches.count) == (
        n_fwd + 2, n_bwd + 2)
    pl = logits.clone().requires_grad_(True)
    pr = ref.moe_route_ref(pl, 4, capacity=20, n_valid=60)
    want, = torch.autograd.grad((pr.weights * dw).sum() + pr.prob_sum.sum(),
                                pl)
    assert _rel_err(got, want) < 1e-5
    pl = logits.clone().requires_grad_(True)
    pw, _ = ref.moe_topk_ref(pl, 4, n_valid=60)
    want, = torch.autograd.grad((pw * dw).sum(), pl)
    assert _rel_err(got_topk, want) < 1e-5


# -------------------------------------------- family training gradients
def _plain_kernels(monkeypatch):
    monkeypatch.setattr(ops, "grouped_flash", ref.grouped_flash_ref)
    monkeypatch.setattr(ops, "mlstm_scan", ref.mlstm_chunkwise_ref)
    monkeypatch.setattr(ops, "moe_route", ref.moe_route_ref)


def _card_cfg(arch, dtype):
    """The reduced config with the dims the kernels take at full size:
    MLA's query-key dim 192 and value dim 128, hymba's 16 SSD state dims
    (the reduced 24 / 16 and 4 are no kernel's shapes)."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype=dtype)
    if cfg.mla is not None:
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, qk_nope_head_dim=128, qk_rope_head_dim=64,
            v_head_dim=128))
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               state_dim=16))
    return cfg


def _family_batch(cfg, cuda, b=2, s=96):
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=g).to(cuda)
    batch = {"tokens": toks, "labels": toks}
    if cfg.encoder_layers:
        batch["frames"] = _randn((b, cfg.encoder_len, cfg.d_model),
                                 torch.float32, cuda, 95)
    if cfg.vision_tokens:
        batch["vision_embeds"] = _randn((b, cfg.vision_tokens, cfg.d_model),
                                        torch.float32, cuda, 96)
    return batch


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b",
                                  "xlstm-350m", "hymba-1.5b",
                                  "seamless-m4t-medium", "internvl2-1b"])
def test_family_train_loss_gradient_on_the_card_matches_plain_path(
        cuda, monkeypatch, arch):
    """Each family reduced (kernel dims kept), float32: loss and every
    gradient leaf through
    the kernels and their backward kernels against the plain path, 1e-4
    of the leaf's own max |plain|."""
    from repro_torch.models.transformer import Model
    from repro_torch.models.weights import tree_leaves
    from repro_torch.training import trainer
    model = Model(_card_cfg(arch, "float32"), device="cuda")
    params = model.init_params(seed=3)
    batch = _family_batch(model.cfg, cuda)
    counts = {c: c.bwd_launches.count for c in (kflash, kscan, kmoe)}
    loss, grads = trainer.value_and_grad(model, params, batch)
    torch.cuda.synchronize()
    ran = {c.__name__.split(".")[-1]: c.bwd_launches.count - n
           for c, n in counts.items()}
    cfg = model.cfg
    assert (ran["moe_topk"] > 0) == (cfg.moe is not None), ran
    assert (ran["mlstm_scan"] > 0) == (cfg.ssm is not None), ran
    assert (ran["flash_attention"] > 0) == (cfg.family != "ssm"), ran
    _plain_kernels(monkeypatch)
    ploss, pgrads = trainer.value_and_grad(model, params, batch)
    assert abs(loss.item() - ploss.item()) < 1e-4
    for g, w in zip(tree_leaves(grads), tree_leaves(pgrads)):
        scale = max(w.abs().max().item(), 1e-30)
        assert ((g - w).abs().max() / scale).item() < 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b",
                                  "xlstm-350m", "hymba-1.5b"])
def test_family_train_loss_gradient_on_the_card_is_bit_identical(cuda, dtype,
                                                                 arch):
    """Two gradients of one loss give the same bits: the dispatch gather's
    gradient is a gather and a sum in order, the backward kernels use no
    atomics (what ``--resume`` needs to repeat an uninterrupted run)."""
    from repro_torch.models.transformer import Model
    from repro_torch.models.weights import tree_leaves
    from repro_torch.training import trainer
    model = Model(_card_cfg(arch, dtype), device="cuda")
    params = model.init_params(seed=4)
    batch = _family_batch(model.cfg, cuda, s=128)
    l1, g1 = trainer.value_and_grad(model, params, batch)
    l2, g2 = trainer.value_and_grad(model, params, batch)
    torch.cuda.synchronize()
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(g1), tree_leaves(g2)))


# ------------------------------------------------- counting on the card
def test_analyze_on_the_card_counts_each_kernel_by_its_formula(cuda):
    """``roofline.analysis.analyze`` of a prefill and a train step on the
    card: the kernels (bound with ctypes, unseen by the dispatcher) report
    their ``kernels.work`` counts, the matrix products theirs, and the
    result equals the uncounted call's."""
    from repro_torch.kernels import work
    from repro_torch.models.transformer import Model
    from repro_torch.models.weights import tree_leaves
    from repro_torch.roofline import analysis as RA
    cfg = get_arch("llama3.2-1b").reduced()
    model = Model(cfg, device="cuda")
    params = model.init_params(seed=0)
    b, s = 2, 64
    toks = torch.randint(0, cfg.vocab_size, (b, s), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0)).cuda()
    want, _ = model.prefill(params, {"tokens": toks}, 128)
    n = kflash.launches.count
    r = RA.analyze(model.prefill, params, {"tokens": toks}, 128,
                   dtype=torch.float32)
    assert kflash.launches.count == n + cfg.n_layers
    one = work.flash(torch.empty(b, s, cfg.n_heads, cfg.hd),
                     torch.empty(b, s, cfg.n_kv_heads, cfg.hd),
                     torch.empty(b, s, cfg.n_kv_heads, cfg.hd))
    k1 = r.kernels["flash_attention"]
    assert (k1["calls"], k1["ops"]) == (cfg.n_layers, cfg.n_layers * one.ops)
    layer_w = sum(x.numel() for x in tree_leaves(params["segments"])
                  if x.dim() == 3)
    assert r.flops - k1["ops"] == 2 * b * s * layer_w \
        + 2 * b * cfg.vocab_size * cfg.d_model
    got, _ = model.prefill(params, {"tokens": toks}, 128)
    assert torch.equal(got, want)
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    n_bwd = kflash.bwd_launches.count
    r = RA.analyze(lambda: torch.autograd.grad(model.train_loss(
        params, {"tokens": toks, "labels": toks})[0], leaves),
        dtype=torch.float32)
    assert kflash.bwd_launches.count == n_bwd + cfg.n_layers
    assert r.kernels["flash_attention_bwd"]["calls"] == cfg.n_layers


# ------------------------------------------------ the dry-run's branches
def test_real_cuda_calls_launch_and_take_no_dry_run_branch(cuda, monkeypatch):
    """A real CUDA tensor reaches each kernel as before: its launch counter
    moves, the output is a real tensor, and neither the DTensor branch
    (``ops.on_shards``) nor a wrapper's shape-only return is taken."""
    from torch._subclasses.fake_tensor import FakeTensor

    def refuse(*a, **k):
        raise AssertionError("DTensor branch on a CUDA tensor")
    monkeypatch.setattr(ops, "on_shards", refuse)
    bf = torch.bfloat16
    q = _randn((2, 128, 8, 64), bf, cuda, 1).requires_grad_(True)
    kv = _randn((2, 128, 2, 64), bf, cuda, 2)
    sq = _randn((4, 128, 64), bf, cuda, 3).requires_grad_(True)
    gates = _randn((4, 128), torch.float32, cuda, 4)
    logits = _randn((256, 64), torch.float32, cuda, 5).requires_grad_(True)
    calls = [
        (kflash.launches, lambda: ops.grouped_flash(q, kv, kv)),
        (kflash.bwd_launches,
         lambda: ops.grouped_flash(q, kv, kv).float().sum().backward()),
        (kdecode.launches,
         lambda: ops.grouped_decode(q[:, :1].detach(), kv, kv, 100)),
        (kscan.launches, lambda: ops.mlstm_scan(sq, sq, sq, gates, gates)),
        (kscan.bwd_launches, lambda: ops.mlstm_scan(
            sq, sq, sq, gates, gates).float().sum().backward()),
        (kmoe.launches, lambda: ops.moe_route(logits, 4, capacity=16)),
        (kmoe.bwd_launches, lambda: ops.moe_route(
            logits, 4, capacity=16).weights.sum().backward())]
    for counter, call in calls:
        before = counter.count
        out = call()
        torch.cuda.synchronize()
        assert counter.count == before + 1
        for t in (out if isinstance(out, tuple) else (out,)):
            assert t is None or not isinstance(t, FakeTensor)


def test_dry_run_on_the_card_allocates_nothing(cuda):
    """A traced cell on ``device="cuda"`` (fake tensors over DTensor) holds
    no memory of the card, before, after or at its peak, and counts the
    kernels of its path."""
    import gc

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    gc.collect()    # earlier tests' garbage is not the dry run's to free
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counts = [c.count for c in (kflash.launches, kflash.bwd_launches)]
    rec = dryrun.trace(get_arch("llama3.2-1b"),
                       ShapeConfig("train", 4096, 64, "train"), (4, 2),
                       ("data", "model"), device="cuda")
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    assert torch.cuda.max_memory_allocated() == before
    assert rec["status"] == "ok"
    assert {"flash_attention", "flash_attention_bwd"} <= set(
        rec["roofline"]["kernels"])
    assert [c.count for c in (kflash.launches, kflash.bwd_launches)] == counts


# ------------------------------------------------ DTensors under local_map
@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A one-rank NCCL group and its (1, 1) (data, model) mesh for the
    test (one card: two ranks cannot share it in one communicator)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


def _dt(mesh, t, grad=False):
    from torch.distributed.tensor import Replicate, distribute_tensor
    d = distribute_tensor(t, mesh, [Replicate(), Replicate()])
    return d.detach().requires_grad_(True) if grad else d


def _counts():
    return (kflash.launches.count, kflash.bwd_launches.count,
            kdecode.launches.count, kscan.launches.count,
            kscan.bwd_launches.count, kmoe.launches.count,
            kmoe.bwd_launches.count)


def _grads_of(fn, inputs, douts):
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * d).sum() for o, d in zip(outs, douts) if d is not None)
    return [o.detach() for o in outs], torch.autograd.grad(loss, inputs)


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_under_local_map_equal_the_plain_tensor_calls(
        nccl_mesh, dtype):
    """K1, K3 and K4 forward and backward, and K2, called with CUDA
    DTensors on the one-rank mesh: each launches its kernels once a call
    (forward and backward) as the plain call does, and gives the same
    outputs and gradients, bit for bit (the same kernels on the same
    shard)."""
    cuda = torch.device("cuda")
    q = _randn((2, 256, 8, 64), dtype, cuda, 200)
    k = _randn((2, 256, 2, 64), dtype, cuda, 201)
    v = _randn((2, 256, 2, 64), dtype, cuda, 202)
    do = _randn((2, 256, 8, 64), dtype, cuda, 203)
    sq = _randn((4, 256, 512), dtype, cuda, 204)
    lf = torch.nn.functional.logsigmoid(_randn((4, 256), torch.float32,
                                               cuda, 205) + 2)
    ig = _randn((4, 256), torch.float32, cuda, 206)
    dh = _randn((4, 256, 512), dtype, cuda, 207)
    logits = _randn((512, 64), torch.float32, cuda, 208)
    dw = _randn((512, 4), torch.float32, cuda, 209)
    dps = _randn((64,), torch.float32, cuda, 210)
    lengths = torch.tensor([256, 100], dtype=torch.int32, device=cuda)
    cases = [
        (ops.grouped_flash, (q, k, v), (do,), (1, 1, 0, 0, 0, 0, 0)),
        (lambda a, b, c, f, i: ops.mlstm_scan(a, b, c, f, i),
         (sq, sq, sq, lf, ig), (dh,), (0, 0, 0, 1, 1, 0, 0)),
        (lambda lg: tuple(ops.moe_route(lg, 4, capacity=40, n_valid=60)),
         (logits,), (dw, None, None, None, dps, None),
         (0, 0, 0, 0, 0, 1, 1))]
    for fn, ins, douts, want in cases:
        before = _counts()
        d_out, d_grads = _grads_of(
            fn, [_dt(nccl_mesh, t, grad=True) for t in ins],
            [None if t is None else _dt(nccl_mesh, t) for t in douts])
        torch.cuda.synchronize()
        mid = _counts()
        p_out, p_grads = _grads_of(
            fn, [t.clone().requires_grad_(True) for t in ins], douts)
        torch.cuda.synchronize()
        after = _counts()
        assert tuple(m - b for m, b in zip(mid, before)) == want
        assert tuple(a - m for a, m in zip(after, mid)) == want
        for a, b in zip(list(d_out) + list(d_grads), list(p_out) + list(p_grads)):
            assert torch.equal(_whole(a), b)
    before = _counts()
    got = ops.grouped_decode(_dt(nccl_mesh, q[:, :1]), _dt(nccl_mesh, k),
                             _dt(nccl_mesh, v), _dt(nccl_mesh, lengths))
    want = ops.grouped_decode(q[:, :1], k, v, lengths)
    torch.cuda.synchronize()
    assert _counts()[2] - before[2] == 2
    assert torch.equal(_whole(got), want)


def test_a_non_contiguous_shard_reaches_the_kernel(nccl_mesh, monkeypatch):
    """A rank's shard that is a view with a strided head dim (what a
    ``redistribute`` can hand over): the DTensor branch makes it contiguous
    and the kernel takes it, forward and backward, as it takes the
    contiguous tensor; the plain version is never called.  The same view
    passed to the wrapper directly is copied there (bf16, counted in
    ``tma_copies``); under ``local_map`` the forward copies nothing for a
    tensor map, and the backward copies one input: the gradient of
    ``out.sum()``, ones expanded with every stride 0, which no tensor map
    describes."""
    from torch.distributed.tensor import DTensor, Replicate
    cuda = torch.device("cuda")
    for name in ("grouped_flash_ref", "grouped_flash_bwd_ref",
                 "mlstm_chunkwise_ref"):
        monkeypatch.setattr(ref, name, lambda *a, **kw: (_ for _ in ()).throw(
            AssertionError("the plain version was called")))
    qt = _randn((2, 256, 64, 8), torch.bfloat16, cuda, 220).transpose(2, 3)
    assert qt.stride(-1) != 1
    k = _randn((2, 256, 2, 64), torch.bfloat16, cuda, 221)
    v = _randn((2, 256, 2, 64), torch.bfloat16, cuda, 222)
    c = kflash.tma_copies.count
    ops.grouped_flash(qt, k, v)
    torch.cuda.synchronize()
    assert kflash.tma_copies.count == c + 1
    dq = DTensor.from_local(qt, nccl_mesh, [Replicate(), Replicate()],
                            run_check=False).detach().requires_grad_(True)
    n = (kflash.launches.count, kflash.bwd_launches.count)
    c = kflash.tma_copies.count
    out = ops.grouped_flash(dq, _dt(nccl_mesh, k), _dt(nccl_mesh, v))
    g, = torch.autograd.grad(out.sum(), dq)
    torch.cuda.synchronize()
    assert (kflash.launches.count, kflash.bwd_launches.count) == (
        n[0] + 1, n[1] + 1)
    assert kflash.tma_copies.count == c + 1
    pq = qt.contiguous().requires_grad_(True)
    pout = ops.grouped_flash(pq, k, v)
    pg, = torch.autograd.grad(pout.sum(), pq)
    assert torch.equal(out.full_tensor(), pout)
    assert torch.equal(g.full_tensor(), pg)
    st = _randn((4, 512, 256), torch.bfloat16, cuda, 223).transpose(1, 2)
    lf = torch.nn.functional.logsigmoid(_randn((4, 256), torch.float32,
                                               cuda, 224) + 2)
    ig = _randn((4, 256), torch.float32, cuda, 225)
    ds = DTensor.from_local(st, nccl_mesh, [Replicate(), Replicate()],
                            run_check=False)
    n = kscan.launches.count
    got = ops.mlstm_scan(ds, ds, ds, _dt(nccl_mesh, lf), _dt(nccl_mesh, ig))
    torch.cuda.synchronize()
    assert kscan.launches.count == n + 1
    c = st.contiguous()
    assert torch.equal(got.full_tensor(), ops.mlstm_scan(c, c, c, lf, ig))
