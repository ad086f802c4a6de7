"""The port's kernel plain versions against the reference package's: the
dense oracles in ``repro.kernels.ref``, the Pallas kernels run in interpret
mode, and the reference's grouped attention helpers; K2's and K3's plans
and the arithmetic of their split designs.  Same numpy inputs
into both packages; float32 to 2e-5, bfloat16 to 3e-2 (the tolerances of
tests/test_kernels.py).  The CUDA kernels themselves are held against these
plain versions on the card (tests/test_torch_kernels_gpu.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import mlstm_scan as tscan
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def both(a, dtype="float32"):
    """The same values as a torch CPU tensor and a JAX array."""
    return (torch.from_numpy(a).to(TDT[dtype]),
            jnp.asarray(a).astype(JDT[dtype]))


def maxdiff(t, j):
    return float(np.max(np.abs(t.float().numpy()
                               - np.asarray(j.astype(jnp.float32)))))


# ------------------------------------------------------------ flash attn
@pytest.mark.parametrize("bh,sq,sk,d", [(4, 256, 256, 64), (2, 128, 256, 32),
                                        (1, 512, 512, 128), (3, 128, 128, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_matches_reference_oracle(bh, sq, sk, d, dtype):
    (tq, jq), (tk, jk), (tv, jv) = (both(rand((bh, n, d), i), dtype)
                                    for i, n in ((1, sq), (2, sk), (3, sk)))
    r = jref.flash_attention_ref(jq, jk, jv, causal=True)
    o = tops.flash_attention(tq, tk, tv, causal=True)
    assert o.dtype == TDT[dtype] and o.shape == (bh, sq, d)
    assert maxdiff(o, r) < TOL[dtype]


@pytest.mark.parametrize("bh,sq,sk,d,causal,window", [
    (4, 256, 256, 64, True, 0),
    (2, 128, 256, 32, True, 0),
    (3, 128, 128, 16, True, 0),
    (1, 512, 512, 128, True, 0),
    (2, 256, 256, 32, True, 64),
    (2, 128, 128, 64, False, 0),
])
def test_flash_ref_matches_pallas_interpret(bh, sq, sk, d, causal, window):
    (tq, jq), (tk, jk), (tv, jv) = (both(rand((bh, n, d), i))
                                    for i, n in ((4, sq), (5, sk), (6, sk)))
    r = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                             backend="interpret", block_q=128, block_k=128)
    o = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert maxdiff(o, r) < 2e-5


@pytest.mark.parametrize("b,s,h,kh,d,causal,window", [
    (2, 64, 8, 2, 16, True, 0),       # G = 4
    (1, 96, 14, 2, 32, True, 0),      # G = 7 (qwen2-0.5b heads)
    (2, 128, 8, 2, 32, True, 32),     # sliding window
    (2, 64, 8, 2, 16, False, 0),      # non-causal
    (1, 100, 14, 2, 16, True, 0),     # ragged length, G = 7
])
def test_grouped_flash_ref_matches_reference(b, s, h, kh, d, causal, window):
    """The port's grouped layout (no K/V repeat) against the reference's
    repeat-and-flatten ``_grouped_flash`` on its blocked xla path."""
    (tq, jq) = both(rand((b, s, h, d), 7))
    (tk, jk), (tv, jv) = (both(rand((b, s, kh, d), i)) for i in (8, 9))
    r = jattn._grouped_flash(jq, jk, jv, causal=causal, window=window,
                             backend="xla")
    o = tops.grouped_flash(tq, tk, tv, causal=causal, window=window)
    assert o.shape == (b, s, h, d)
    assert maxdiff(o, r) < 2e-5


def test_flash_ref_ragged_and_short_queries():
    """Sq < Sk places the queries at the last positions; lengths that are
    not block multiples need no padding."""
    (tq, jq) = both(rand((3, 37, 16), 10))
    (tk, jk), (tv, jv) = (both(rand((3, 101, 16), i)) for i in (11, 12))
    for causal, window in ((True, 0), (True, 20), (False, 0)):
        r = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
        o = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
        assert maxdiff(o, r) < 2e-5


# ---------------------------------------------------------- decode attn
@pytest.mark.parametrize("bh,s,d", [(6, 512, 64), (2, 2048, 128), (8, 256, 32)])
def test_decode_ref_matches_pallas_interpret(bh, s, d):
    (tq, jq) = both(rand((bh, 1, d), 1))
    (tk, jk), (tv, jv) = (both(rand((bh, s, d), i)) for i in (2, 3))
    lengths = (np.arange(bh) * (s // bh) + 1).astype(np.int32)
    r_ref = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths))
    r_pl = jops.decode_attention(jq, jk, jv, jnp.asarray(lengths),
                                 backend="interpret", block_k=128)
    o = tops.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    assert maxdiff(o, r_ref) < 2e-5
    assert maxdiff(o, r_pl) < 2e-5


@pytest.mark.parametrize("b,s,h,kh,d,length", [
    (2, 64, 8, 2, 16, 40),       # G = 4
    (3, 48, 14, 2, 32, 48),      # G = 7, full cache
    (2, 32, 4, 4, 64, 1),        # G = 1, one live position
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_decode_ref_matches_reference(b, s, h, kh, d, length, dtype):
    """The decode kernel's plain version against the reference's einsum
    ``_grouped_decode`` -- the function the reference's decode step runs."""
    (tq, jq) = both(rand((b, 1, h, d), 4), dtype)
    (tk, jk), (tv, jv) = (both(rand((b, s, kh, d), i), dtype) for i in (5, 6))
    r = jattn._grouped_decode(jq, jk, jv, length)
    o = tops.grouped_decode(tq, tk, tv,
                            torch.full((b,), length, dtype=torch.int32))
    assert o.dtype == TDT[dtype]
    assert maxdiff(o, r) < TOL[dtype]


def test_grouped_decode_ref_ragged_lengths():
    """Per-row lengths: each (row, KV head) group against the reference
    oracle on the head-expanded (BH, 1, D) form."""
    b, s, h, kh, d = 3, 80, 14, 2, 16
    q, k, v = rand((b, 1, h, d), 7), rand((b, s, kh, d), 8), rand((b, s, kh, d), 9)
    lengths = np.array([1, 33, 80], np.int32)
    o = tops.grouped_decode(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(lengths))
    g = h // kh
    qf = q.transpose(0, 2, 1, 3).reshape(b * h, 1, d)
    kf = np.repeat(k.transpose(0, 2, 1, 3), g, axis=1).reshape(b * h, s, d)
    vf = np.repeat(v.transpose(0, 2, 1, 3), g, axis=1).reshape(b * h, s, d)
    r = jref.decode_attention_ref(jnp.asarray(qf), jnp.asarray(kf),
                                  jnp.asarray(vf),
                                  jnp.asarray(np.repeat(lengths, h)))
    r = np.asarray(r).reshape(b, h, 1, d).transpose(0, 2, 1, 3)
    assert np.max(np.abs(o.numpy() - r)) < 2e-5


# -------------------------------------------------------------- dispatch
def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise: a CPU tensor is refused, never
    quietly run through the plain version."""
    q = torch.zeros((1, 8, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="CUDA"):
        tdecode.decode_attention(q[:, :1], q[:, :, :2], q[:, :, :2],
                                 torch.ones((1,), dtype=torch.int32))


def test_ops_dispatch_by_device():
    """CPU tensors take the plain version; a device with no path raises."""
    q = torch.from_numpy(rand((1, 8, 4, 16), 1))
    k = torch.from_numpy(rand((1, 8, 2, 16), 2))
    out = tops.grouped_flash(q, k, k, causal=True)
    assert torch.equal(out, tref.grouped_flash_ref(q, k, k, causal=True))
    with pytest.raises(ValueError, match="no path"):
        tops.grouped_flash(q.to("meta"), k.to("meta"), k.to("meta"))
    with pytest.raises(ValueError, match="no path"):
        tops.grouped_decode(q[:, :1].to("meta"), k.to("meta"), k.to("meta"),
                            torch.ones((1,), dtype=torch.int32))


# ------------------------------------------------------ K2's split plan
@pytest.mark.parametrize("s_max,b,kh", [
    (1024, 8, 8),        # llama3.2-1b decode step: 64 (row, KV head) pairs
    (1024, 8, 16),       # qwen2-moe-a2.7b: 128 pairs
    (1024, 8, 2),        # qwen2-0.5b
    (1000, 3, 2),        # S_max not a multiple of the tile
    (64, 1, 1),          # one tile
    (5, 2, 2),           # shorter than a tile
    (512, 64, 16),       # more pairs than blocks wanted: one split
    (131072, 1, 1),      # a long cache
])
def test_split_plan_covers_the_cache_once(s_max, b, kh):
    n_split, chunk = tdecode.split_plan(s_max, b, kh)
    assert n_split >= 1 and chunk % tdecode.SPLIT_TILE == 0
    covered = np.zeros(s_max, np.int32)
    for i in range(n_split):
        lo, hi = i * chunk, min(s_max, (i + 1) * chunk)
        assert lo < hi                        # no split is empty by shape
        covered[lo:hi] += 1
    assert (covered == 1).all()
    target = tdecode.BLOCKS_PER_SM * tdecode.H100_SMS
    assert n_split == 1 or n_split * b * kh <= 1.5 * target


@pytest.mark.parametrize("b,s,h,kh,d,lengths", [
    (2, 256, 8, 2, 16, [100, 256]),         # G = 4, S_max in full
    (3, 200, 14, 2, 32, [0, 1, 129]),       # G = 7, lengths 0 and 1
    (2, 192, 4, 4, 64, [63, 65]),           # split boundary -1, +1
    (2, 100, 16, 1, 16, [64, 99]),          # G = 16
])
def test_split_ref_matches_dense_and_pallas(b, s, h, kh, d, lengths):
    """K2's split-and-merge arithmetic, on the split plan, against the dense
    plain version (rows with live positions) and the reference's Pallas
    kernel in interpret mode on the head-expanded (BH, 1, D) form (every
    row, length 0 included: both give 0 there)."""
    q, k, v = rand((b, 1, h, d), 13), rand((b, s, kh, d), 14), rand((b, s, kh, d), 15)
    lens = np.array(lengths, np.int32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    n_split, chunk = tdecode.split_plan(s, b, kh)
    assert n_split > 1
    o = tref.grouped_decode_split_ref(tq, tk, tv, torch.from_numpy(lens),
                                      n_split=n_split, chunk=chunk)
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


# -------------------------------------------------------- K3's scan plan
@pytest.mark.parametrize("bh,s,dk,dv", [
    (4, 500, 512, 512),      # xlstm-350m bulk prefill, B = 1
    (32, 256, 512, 512),     # xlstm-350m admission, B = 8
    (200, 256, 16, 64),      # hymba's SSD heads
    (2, 256, 32, 32),
    (3, 37, 32, 96),         # one ragged chunk, dv not a multiple of 64
    (1, 1, 64, 64),
    (1, 129, 128, 8),
    (8, 1024, 512, 512),
])
def test_scan_plan_covers_the_sequence_and_columns_once(bh, s, dk, dv):
    plan = tscan.scan_plan(bh, s, dk, dv)
    steps = np.zeros(s, np.int32)
    for c in range(plan.n_chunks):
        lo, hi = c * plan.chunk, min(s, (c + 1) * plan.chunk)
        assert lo < hi                        # no chunk is empty
        steps[lo:hi] += 1
    assert (steps == 1).all()
    cols = np.zeros(dv, np.int32)
    for y in range(-(-dv // plan.cols)):
        cols[y * plan.cols:(y + 1) * plan.cols] += 1
    assert (cols == 1).all()
    blocks = bh * -(-dv // plan.cols)
    few = dk <= tscan.CP_SMALL_DK or (blocks <= tscan.CP_MAX_BLOCKS
                                      and plan.n_chunks >= tscan.CP_MIN_CHUNKS)
    few = few and (plan.n_chunks - 1) * bh * dk * dv * 4 <= tscan.CP_MAX_SCRATCH
    assert plan.design == ("chunk_parallel" if few else "single")


def test_scan_plan_picks_chunk_parallel_for_bulk_prefill():
    """A bulk prefill of one row-head (8 blocks) over 8 chunks or more runs
    chunk-parallel; xlstm-350m's (B 1 x H 4 = 4 row-heads) runs the single
    pass, timed 1.66x faster there on the H100; forced, its chunk-parallel
    design still launches (a) over at least 128 blocks."""
    bulk = tscan.scan_plan(1, 500, 512, 512)
    assert (bulk.design, bulk.chunk, bulk.n_chunks) == ("chunk_parallel", 64, 8)
    xlstm = tscan.scan_plan(4, 500, 512, 512)
    assert (xlstm.design, xlstm.n_chunks) == ("single", 8)
    forced = tscan.scan_plan(4, 500, 512, 512, design="chunk_parallel")
    assert 4 * (512 // forced.cols) * (forced.n_chunks - 1) >= 128  # (a) local
    admit = tscan.scan_plan(32, 256, 512, 512)
    assert (admit.design, admit.n_chunks) == ("single", 4)
    assert tscan.scan_plan(4, 500, 512, 512, design="single").design == "single"
    with pytest.raises(ValueError, match="no design"):
        tscan.scan_plan(4, 500, 512, 512, design="sequential")


@pytest.mark.parametrize("bh,s,design", [
    # the faster design in the H100 timings of both (dk = dv = 512; the
    # one point where the rule misses, BH 2 at S 500, chunk-parallel 1.18x
    # faster, is left out)
    (1, 128, "single"), (1, 256, "single"), (1, 500, "chunk_parallel"),
    (1, 1024, "chunk_parallel"), (1, 2048, "chunk_parallel"),
    (2, 2048, "single"), (4, 256, "single"), (4, 500, "single"),
    (8, 256, "single"), (8, 2048, "single"), (16, 500, "single"),
    (16, 1024, "single"), (32, 2048, "single"),
    (4, 4096, "single"),     # past the scratch cap, not timed
])
def test_scan_plan_follows_the_measured_crossover(bh, s, design):
    assert tscan.scan_plan(bh, s, 512, 512).design == design


@pytest.mark.parametrize("bh,s,design", [
    # the faster design in the H100 timings of both at hymba's SSD heads
    # (dk = 16, dv = 64): every point timed, chunk-parallel wherever its
    # scratch fits; at BH 100, S 256 and 500 the single pass was 1.16-1.18x
    # faster and the one rule for small states keeps chunk-parallel there
    *[(bh, s, "chunk_parallel") for bh in (25, 50, 100, 200)
      for s in (64, 128, 256, 500, 1024, 2048)],
])
def test_scan_plan_follows_the_measured_crossover_at_small_states(bh, s,
                                                                  design):
    assert tscan.scan_plan(bh, s, 16, 64).design == design


def _scan_arrays(bh, s, dk, dv, seed):
    q, k = rand((bh, s, dk), seed) * 0.5, rand((bh, s, dk), seed + 1) * 0.5
    v = rand((bh, s, dv), seed + 2)
    logf = np.array(jax.nn.log_sigmoid(rand((bh, s), seed + 3) + 2.0))
    i = np.array(jax.nn.sigmoid(rand((bh, s), seed + 4)))
    return q, k, v, logf, i


@pytest.mark.parametrize("bh,s,dk,dv,scale", [
    (2, 256, 32, 32, None),
    (3, 100, 16, 64, 1.0),       # ragged; hymba's scale
    (1, 500, 16, 16, None),      # the bulk prefill's length
    (2, 37, 32, 24, None),       # one ragged chunk
    (1, 129, 8, 8, None),        # one step past two chunks
])
@pytest.mark.parametrize("against", ["chunkwise", "interpret"])
def test_chunk_parallel_ref_matches_chunkwise_and_pallas(bh, s, dk, dv, scale,
                                                         against):
    """K3's chunk-parallel arithmetic (local states, one carried pass,
    parallel outputs) against the chunkwise plain version and the Pallas
    kernel in interpret mode, chunks of 64, float32.  The Pallas kernel
    takes whole chunks only: its inputs are padded with logf = 0 and i = 0,
    which is exact, and the padded rows are cut."""
    arrs = _scan_arrays(bh, s, dk, dv, 40)
    o = tref.mlstm_chunk_parallel_ref(*(torch.from_numpy(a) for a in arrs),
                                      scale=scale, chunk=64)
    assert o.shape == (bh, s, dv) and o.dtype == torch.float32
    if against == "chunkwise":
        r = tref.mlstm_chunkwise_ref(*(torch.from_numpy(a) for a in arrs),
                                     scale=scale, chunk=64).numpy()
    else:
        pad = -s % 64
        padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
                  for a in arrs]
        r = np.asarray(jops.mlstm_scan(*(jnp.asarray(a) for a in padded),
                                       chunk=64, scale=scale,
                                       backend="interpret"))[:, :s]
    assert np.max(np.abs(o.numpy() - r)) < 2e-5


@pytest.mark.parametrize("bh,s,dk,dv,scale", [
    (2, 1, 64, 64, None),        # one step
    (2, 63, 16, 64, 1.0),        # hymba's head dims and scale, one chunk
    (1, 64, 512, 64, None),      # one whole chunk, eight panels
    (2, 65, 64, 512, None),      # one step past a chunk, dv 512
    (1, 129, 512, 512, None),    # xlstm's head dims, one past two chunks
    (2, 129, 16, 64, 1.0),       # hymba, ragged over three chunks
    (1, 129, 96, 64, None),      # two consumers, the second's panel ragged
])
@pytest.mark.parametrize("against", ["chunkwise", "chunkwise_bf16",
                                     "interpret"])
def test_single_pass_ref_matches_chunkwise_and_pallas(bh, s, dk, dv, scale,
                                                      against):
    """K3's bf16 single pass as its arithmetic runs (dk in 64-column
    panels summed in panel order, the normaliser's shares a panel at a
    time, the bf16 copies of C, w o V and P) against the chunkwise plain
    version and the Pallas kernel in interpret mode.  Unrounded and in float32 it
    is the same algebra (2e-5); with bf16 inputs and its roundings it meets
    the kernel's gate against the plain version of the same inputs, 3e-2
    of max(1, max |plain|).  The Pallas kernel takes whole chunks only:
    its inputs are padded with logf = 0 and i = 0, which is exact."""
    arrs = _scan_arrays(bh, s, dk, dv, 60)
    t = [torch.from_numpy(a) for a in arrs]
    if against == "chunkwise_bf16":
        t[:3] = [x.bfloat16() for x in t[:3]]
        o = tref.mlstm_single_pass_ref(*t, scale=scale)
        r = tref.mlstm_chunkwise_ref(*t, scale=scale)
        assert o.dtype == torch.bfloat16 and o.shape == (bh, s, dv)
        err = (o.float() - r.float()).abs().max().item()
        assert err < 3e-2 * max(1.0, r.float().abs().max().item())
        return
    o = tref.mlstm_single_pass_ref(*t, scale=scale, rounded=False)
    assert o.shape == (bh, s, dv) and o.dtype == torch.float32
    if against == "chunkwise":
        r = tref.mlstm_chunkwise_ref(*t, scale=scale, chunk=64).numpy()
    else:
        pad = -s % 64
        padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
                  for a in arrs]
        r = np.asarray(jops.mlstm_scan(*(jnp.asarray(a) for a in padded),
                                       chunk=64, scale=scale,
                                       backend="interpret"))[:, :s]
    assert np.max(np.abs(o.numpy() - r)) < 2e-5


@pytest.mark.parametrize("bh,s,dk,dv,scale", [
    (2, 129, 16, 64, 1.0),       # hymba's head dims and scale, ragged
    (1, 64, 32, 32, None),       # one whole chunk
])
def test_scan_study_emulation_unrounded_is_the_chunkwise_ref(bh, s, dk, dv,
                                                             scale):
    """scan_study's float32 emulation of the tensor-core arithmetic, with
    no operand rounded, is the chunkwise plain version at chunks of 64."""
    from repro_torch.launch import scan_study
    q, k, v, logf, i = (torch.from_numpy(a)
                        for a in _scan_arrays(bh, s, dk, dv, 50))
    sc = dk ** -0.5 if scale is None else scale
    got = scan_study.emulate(q, k, v, logf, i, sc, ())
    want = tref.mlstm_chunkwise_ref(q, k, v, logf, i, scale=scale, chunk=64)
    assert got.shape == (bh, s, dv)
    assert torch.max(torch.abs(got - want)).item() < 2e-5
    rounded = scan_study.emulate(q, k, v, logf, i, sc, ("scores",))
    assert 0 < torch.max(torch.abs(rounded - want)).item() < 3e-2


def test_build_flags_give_a_library_of_their_own():
    """A diagnostic build (-DMLSTM_STAMPS) never replaces the served
    library: the flags are part of the hashed file name."""
    from repro_torch.kernels import build
    plain = build._lib_path("mlstm_scan")
    stamped = build._lib_path("mlstm_scan", ("-DMLSTM_STAMPS",))
    assert plain != stamped and plain.parent == stamped.parent
    assert plain == build._lib_path("mlstm_scan", ())


def test_an_edited_header_gives_a_library_of_its_own(tmp_path, monkeypatch):
    """Every ``csrc/*.cuh`` is part of each library's hashed file name, so
    editing a shared header rebuilds the sources that include it instead
    of loading a stale library."""
    from repro_torch.kernels import build
    (tmp_path / "kern.cu").write_text('#include "shared.cuh"\n')
    header = tmp_path / "shared.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build._lib_path("kern")
    assert before == build._lib_path("kern")
    header.write_text("// v2\n")
    after = build._lib_path("kern")
    assert after != before and after.parent == before.parent
    (tmp_path / "other.cuh").write_text("// new\n")
    assert build._lib_path("kern") not in (before, after)


def test_extra_builds_share_the_batch_and_get_libraries_of_their_own(
        tmp_path, monkeypatch):
    """``build.build(extra=...)``: a second build of a source with other
    flags (K1's watchdog build) is compiled in the same batch as the
    others, keyed by its name and flags, into a library of its own; only
    that build gets the flags."""
    import stat
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kflash
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "kern.cu").write_text("// kern\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nfor a; do [ "$prev" = "-o" ] && out="$a"; '
                    'prev="$a"; done\necho "$@" > "$out"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    got = build.build(("kern",), extra=(("kern", kflash.WATCHDOG_FLAGS),))
    key = "kern " + " ".join(kflash.WATCHDOG_FLAGS)
    assert sorted(got) == sorted(["kern", key])
    plain, watch = got["kern"][0], got[key][0]
    assert plain != watch and plain.parent == watch.parent
    assert "-DREPRO_MBAR_WATCHDOG" in watch.read_text()
    assert "-DREPRO_MBAR_WATCHDOG" not in plain.read_text()
    assert watch == build._lib_path("kern", kflash.WATCHDOG_FLAGS)


def test_production_k1_has_no_trap_and_the_watchdog_only_one():
    """ptxas ignores ``setmaxnreg`` in a kernel that can ``__trap()``: the
    production builds of K1's and K3's TMA kernels
    (``flash_attention.cu``, ``flash_attention_bwd.cu``,
    ``mlstm_scan.cu``, ``mlstm_scan_bwd.cu`` and the ``hopper.cuh`` they
    include) have no trap outside the watchdog's ``#ifdef
    REPRO_MBAR_WATCHDOG`` branch, which holds exactly one (comments
    aside)."""
    import re
    from repro_torch.kernels import build
    text = re.sub(r"//[^\n]*", "", "".join(
        (build.CSRC / n).read_text() for n in ("flash_attention.cu",
                                               "flash_attention_bwd.cu",
                                               "mlstm_scan.cu",
                                               "mlstm_scan_bwd.cu",
                                               "hopper.cuh")))
    branch = re.compile(r"#ifdef REPRO_MBAR_WATCHDOG\n(.*?)#else\n",
                        re.DOTALL)
    inside = branch.findall(text)
    assert len(inside) == 1 and inside[0].count("__trap()") == 1
    assert "__trap" not in branch.sub("", text)


# ------------------------------------------------ plain backward versions
# Each written-out gradient against torch autograd of its plain forward,
# float32, 1e-5 of max(1, max |autograd|).
def _grad_err(got, want) -> float:
    return max(((g.float() - w.float()).abs().max()
                / max(1.0, w.float().abs().max().item())).item()
               for g, w in zip(got, want))


def _scan_bwd_inputs(bh, s, dk, dv, qk_scale, ssd, seed):
    t = lambda *shape, sd: torch.from_numpy(rand(shape, sd))  # noqa: E731
    q, k = t(bh, s, dk, sd=seed) * qk_scale, t(bh, s, dk, sd=seed + 1) * qk_scale
    v, dh = t(bh, s, dv, sd=seed + 2), t(bh, s, dv, sd=seed + 3)
    g = t(bh, s, sd=seed + 4)
    if ssd:     # hymba's SSD gates: decay -dt, input weight dt
        dt = torch.nn.functional.softplus(g * 1.5)
        return q, k, v, -dt, dt, dh
    return (q, k, v, torch.nn.functional.logsigmoid(g + 2.0),
            torch.sigmoid(t(bh, s, sd=seed + 5)), dh)


@pytest.mark.parametrize("bh,s,dk,dv,qk_scale,ssd,scale", [
    (2, 64, 8, 16, 2.0, False, None),      # one whole chunk
    (2, 150, 16, 24, 1.5, False, None),    # ragged S over 3 chunks
    (2, 37, 16, 8, 2.0, False, None),      # S below one chunk
    (3, 200, 16, 64, 0.7, True, 1.0),      # SSD gates, scale 1.0
    (2, 130, 32, 32, 1.5, False, None),
])
def test_mlstm_chunkwise_bwd_ref_matches_autograd(bh, s, dk, dv, qk_scale,
                                                  ssd, scale):
    """Both branches of the normaliser max(|a|, 1) are exercised: some rows
    have |a| > 1 (the gradient flows through a), others not."""
    q, k, v, logf, i, dh = _scan_bwd_inputs(bh, s, dk, dv, qk_scale, ssd, 7)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v, logf, i)]
    want = torch.autograd.grad(
        tref.mlstm_chunkwise_ref(*xs, scale=scale), xs, dh)
    got = tref.mlstm_chunkwise_bwd_ref(q, k, v, logf, i, dh, scale=scale)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert _grad_err(got, want) < 1e-5
    # both branches: recompute a as the forward does (chunk 64)
    sc = dk ** -0.5 if scale is None else scale
    n = torch.zeros((bh, dk))
    a = torch.empty((bh, s))
    f, ig, qs = logf.exp(), i, q * sc
    for t in range(s):
        n = f[:, t, None] * n + ig[:, t, None] * k[:, t]
        a[:, t] = (qs[:, t] * n).sum(-1)
    assert (a.abs() > 1).any() and (a.abs() < 1).any()


def test_mlstm_chunkwise_ref_gradient_is_finite_at_ssd_decays():
    """Steep decays over a chunk of 256 overflow exp above the diagonal;
    the plain forward masks before the exponential, so autograd of it
    stays finite (the float32 training check on the card compares
    against it)."""
    q, k, v, logf, i, dh = _scan_bwd_inputs(2, 256, 16, 64, 1.0, True, 3)
    logf = logf * 4.0
    xs = [x.clone().requires_grad_(True) for x in (q, k, v, logf, i)]
    grads = torch.autograd.grad(
        tref.mlstm_chunkwise_ref(*xs, scale=1.0, chunk=256), xs, dh)
    assert all(torch.isfinite(g).all() for g in grads)
    got = tref.mlstm_chunkwise_bwd_ref(q, k, v, logf, i, dh, scale=1.0)
    assert _grad_err(got, grads) < 1e-5


@pytest.mark.parametrize("t,e,k,n_valid,scale,cap", [
    (8, 64, 4, 60, 1.0, 1),        # qwen2-moe decode: padded experts, drops
    (200, 64, 4, 60, 1.0, 10),
    (50, 256, 8, 256, 2.5, 2),     # deepseek's router scale
    (40, 16, 1, 12, 1.0, 3),       # k = 1
])
def test_moe_route_bwd_ref_matches_autograd(t, e, k, n_valid, scale, cap):
    logits = torch.from_numpy(rand((t, e), 30 + k))
    dw = torch.from_numpy(rand((t, k), 31))
    dps = torch.from_numpy(rand((e,), 32))
    lg = logits.clone().requires_grad_(True)
    r = tref.moe_route_ref(lg, k, capacity=cap, n_valid=n_valid,
                           router_scale=scale)
    assert (r.slot == e * cap).any()                    # dropped pairs
    want, = torch.autograd.grad((r.weights * dw).sum()
                                + (r.prob_sum * dps).sum(), lg)
    got = tref.moe_route_bwd_ref(logits, r.idx, r.weights.detach(), dw, dps,
                                 n_valid=n_valid, router_scale=scale)
    assert _grad_err([got], [want]) < 1e-5
    assert (got[:, n_valid:] == 0).all()
    # without probability sums: moe_topk's gradient
    lg = logits.clone().requires_grad_(True)
    w, idx = tref.moe_topk_ref(lg, k, n_valid=n_valid)
    want, = torch.autograd.grad((w * dw).sum(), lg)
    got = tref.moe_route_bwd_ref(logits, idx, w.detach(), dw, n_valid=n_valid)
    assert _grad_err([got], [want]) < 1e-5


@pytest.mark.parametrize("b,sq,sk,h,causal", [
    (2, 40, 40, 4, True), (1, 70, 70, 2, True), (2, 17, 50, 3, True)])
def test_grouped_flash_bwd_ref_at_mla_dims_matches_autograd(b, sq, sk, h,
                                                            causal):
    """MLA's query-key dim 192 and value dim 128, every head its own KV
    head, as ``mla_forward`` calls it."""
    q = torch.from_numpy(rand((b, sq, h, 192), 40))
    k = torch.from_numpy(rand((b, sk, h, 192), 41))
    v = torch.from_numpy(rand((b, sk, h, 128), 42))
    do = torch.from_numpy(rand((b, sq, h, 128), 43))
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o, lse = tref.grouped_flash_ref(*xs, causal=causal, scale=192 ** -0.5,
                                    return_lse=True)
    want = torch.autograd.grad(o, xs, do)
    got = tref.grouped_flash_bwd_ref(q, k, v, o.detach(), lse.detach(), do,
                                     causal=causal, scale=192 ** -0.5)
    assert [g.shape for g in got] == [(b, sq, h, 192), (b, sk, h, 192),
                                      (b, sk, h, 128)]
    assert _grad_err(got, want) < 1e-5
