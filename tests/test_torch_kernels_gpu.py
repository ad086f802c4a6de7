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


@pytest.mark.parametrize("hd,hdv", [(128, 64), (64, 128), (192, 192),
                                    (192, 64), (128, 192)])
def test_flash_kernel_refuses_other_unequal_dims(cuda, hd, hdv):
    q = torch.zeros((1, 8, 4, hd), device=cuda, dtype=torch.bfloat16)
    v = torch.zeros((1, 8, 4, hdv), device=cuda, dtype=torch.bfloat16)
    n = kflash.launches.count
    with pytest.raises(ValueError, match="head dims"):
        kflash.flash_attention(q, q, v)
    assert kflash.launches.count == n


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
    want = ref.grouped_decode_ref(q, k, v, lens)
    assert (out.float() - want.float()).abs().max().item() < TOL[dtype]


def _edge_lengths(s, b, kh):
    """0, 1, the first split boundary -1, 0, +1, and S_max, cycled over the
    batch rows."""
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
])
def test_decode_kernel_split_edges(cuda, dtype, b, s, h, kh, hd):
    """Lengths at the split plan's edges.  A row of length 0 gets 0, as the
    Pallas kernel gives; the dense plain version gives the mean of V there,
    so those rows are held to 0 instead."""
    q = _randn((b, 1, h, hd), dtype, cuda, 13)
    k = _randn((b, s, kh, hd), dtype, cuda, 14)
    v = _randn((b, s, kh, hd), dtype, cuda, 15)
    lens = torch.tensor(_edge_lengths(s, b, kh), dtype=torch.int32, device=cuda)
    out = kdecode.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    want = ref.grouped_decode_ref(q, k, v, lens)
    live = lens > 0
    assert (out.float() - want.float())[live].abs().max().item() < TOL[dtype]
    assert (out[~live] == 0).all()


def test_decode_kernel_is_deterministic_and_leaves_counters_zero(cuda):
    """Two back-to-back calls on one stream give bit-identical outputs: the
    arrival counters are back at 0 after each call, and the last block
    merges the splits in split order, whichever block it is."""
    b, s, h, kh, hd = 8, 1024, 32, 8, 64
    q = _randn((b, 1, h, hd), torch.bfloat16, cuda, 16)
    k = _randn((b, s, kh, hd), torch.bfloat16, cuda, 17)
    v = _randn((b, s, kh, hd), torch.bfloat16, cuda, 18)
    lens = torch.tensor([700, 1, 1024, 129, 128, 127, 500, 64],
                        dtype=torch.int32, device=cuda)
    first = kdecode.decode_attention(q, k, v, lens)
    second = kdecode.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert not kdecode._counter_buffer(q.device, stream, b * kh).any()


def test_decode_kernel_at_head_dim_80_is_deterministic(cuda):
    """hd 80 reads a row with 10 of a 16-lane group: two calls still give
    bit-identical outputs, and the counters are back at 0."""
    b, s, h, kh, hd = 8, 1024, 32, 32, 80
    q = _randn((b, 1, h, hd), torch.bfloat16, cuda, 19)
    k = _randn((b, s, kh, hd), torch.bfloat16, cuda, 20)
    v = _randn((b, s, kh, hd), torch.bfloat16, cuda, 21)
    lens = torch.tensor([700, 1, 1024, 129, 128, 127, 500, 64],
                        dtype=torch.int32, device=cuda)
    first = kdecode.decode_attention(q, k, v, lens)
    second = kdecode.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert not kdecode._counter_buffer(q.device, stream, b * kh).any()


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
def test_scan_kernel_chunk_edges(cuda, design, s):
    q, k, v, logf, i = _scan_inputs(2, s, 512, 512, torch.bfloat16, cuda)
    out = kscan.mlstm_scan(q, k, v, logf, i, design=design)
    torch.cuda.synchronize()
    assert out.shape == (2, s, 512)
    assert _scan_close(out, ref.mlstm_chunkwise_ref(q, k, v, logf, i))


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
def test_scan_kernel_is_deterministic(cuda, design):
    q, k, v, logf, i = _scan_inputs(4, 500, 512, 512, torch.bfloat16, cuda)
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
    """bfloat16 runs dK/dV and dQ on the tensor cores (the ``wgmma``
    kernels), float32 on the CUDA cores; both start with D's kernel."""
    launched = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = _bwd_inputs(1, 130, 130, 4, 2, hd, dtype, cuda)
        o, lse = kflash.flash_attention(q, k, v, return_lse=True)
        launched[dtype] = _bwd_kernel_names(
            lambda: kflash.flash_attention_bwd(q, k, v, o, lse, do))
    for dtype, names in launched.items():
        wgmma = {n for n in names if "wgmma" in n}
        assert len(names) == 3, (dtype, names)
        assert sum("bwd_delta_kernel" in n for n in names) == 1, names
        if dtype == torch.bfloat16:
            assert (sum("flash_bwd_dkdv_wgmma_kernel" in n for n in wgmma),
                    sum("flash_bwd_dq_wgmma_kernel" in n for n in wgmma)) == (
                1, 1), names
        else:
            assert not wgmma, names
            assert (sum("bwd_dkdv_kernel" in n for n in names),
                    sum("bwd_dq_kernel" in n for n in names)) == (1, 1), names


def test_flash_backward_at_mla_dims_launches_the_kernels_of_its_input_type(
        cuda):
    """MLA's (192, 128): bfloat16 runs the ``wgmma`` kernels (dV and dK
    blocks apart inside one dK/dV launch), float32 the CUDA-core ones."""
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
        wgmma = (sum("flash_bwd_dkdv_wgmma_kernel<192, 128>" in n
                     for n in names),
                 sum("flash_bwd_dq_wgmma_kernel<192, 128>" in n
                     for n in names))
        cuda_cores = (sum("bwd_dkdv_kernel<192, 128>" in n for n in names),
                      sum("bwd_dq_kernel<192, 128>" in n for n in names))
        if dtype == torch.bfloat16:
            assert wgmma == (1, 1) and cuda_cores == (0, 0), names
        else:
            assert wgmma == (0, 0) and cuda_cores == (1, 1), names


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
    CUDA-core kernels and the bf16 ``wgmma`` ones alike (dk up to 512
    changes no register count: the tiles are 64 x 64 whatever dk is)."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    _, _, log_ = build.build(("mlstm_scan_bwd",))["mlstm_scan_bwd"]
    for name in ("scan_bwd_grad_kernel", "scan_bwd_walk_wgmma_kernel",
                 "scan_bwd_norm_wgmma_kernel", "scan_bwd_grad_wgmma_kernel"):
        assert name in log_, name
    assert not [ln for ln in log_.splitlines()
                if re.search(r"[1-9]\d* bytes spill", ln)], log_


# Spill stores K1's bf16 backward kernels may have, as the design notes in
# csrc/flash_attention_bwd.cu state them: the dK/dV kernel at hd 128 (dK,
# dV, S^T and dP^T in registers); every other one none, MLA's (192, 128)
# included (its dQ kernel takes 32-key tiles for that).
BWD_SPILL_STORES = {"flash_bwd_dkdv_wgmma_kernelILi128ELi128E": 48}


def test_flash_backward_wgmma_kernels_spill_no_more_than_stated(
        cuda, tmp_path, monkeypatch):
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    _, _, log_ = build.build(("flash_attention_bwd",))["flash_attention_bwd"]
    spills, name = {}, None
    for ln in log_.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"flash_bwd_\w+?_wgmma_kernelILi\d+ELi\d+E", ln)
            name = m.group(0) if m else None
        elif name and (m := re.search(r"(\d+) bytes spill stores", ln)):
            spills[name] = int(m.group(1))
    assert len(spills) == 2 * (len(kflash.HEAD_DIMS) + len(kflash.DIM_PAIRS))
    over = {n: b for n, b in spills.items() if b > BWD_SPILL_STORES.get(n, 0)}
    assert not over, spills


def test_scan_backward_launches_the_kernels_of_its_input_type(cuda):
    """bfloat16 runs K3's backward on the tensor cores (the two state walks,
    the normaliser and the gradient kernel on ``wgmma``, then the gates'
    kernel); float32 keeps the CUDA-core kernels.  Both start with the
    gates."""
    bf16 = {"scan_bwd_gates_kernel", "scan_bwd_walk_wgmma_kernel<1>",
            "scan_bwd_walk_wgmma_kernel<-1>", "scan_bwd_norm_wgmma_kernel",
            "scan_bwd_grad_wgmma_kernel", "scan_bwd_final_kernel"}
    f32 = {"scan_bwd_gates_kernel", "scan_bwd_outer_kernel",
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
