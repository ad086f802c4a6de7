"""The port's layers, GQA and dense model against the reference package on
the same weights and inputs (float32, CPU).  Weights come from the
reference's ``init_params`` through numpy (``params_from_numpy``); inputs
from numpy with a fixed seed.  Layers to 2e-5, whole-model logits and
caches to 1e-4, greedy tokens identical."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.transformer import Model as JModel
from repro_torch.configs import all_archs
from repro_torch.configs import get_arch as tget_arch
from repro_torch.kernels import decode_attention as kdecode
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import mlstm_scan as kscan
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.transformer import Model as TModel
from repro_torch.models.transformer import build_plan
from repro_torch.models.weights import params_from_numpy, tree_leaves

ARCHS = ["llama3.2-1b", "qwen2-0.5b"]


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(t, j, tol):
    a = t.detach().float().numpy()
    b = np.asarray(j, dtype=np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    assert err < tol, err


def cache_close(tc, jc, tol):
    jl = jax.tree.leaves(jc)
    tl = tree_leaves(tc)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        close(t, j, tol if t.is_floating_point() else 1.0)


# ----------------------------------------------------------------- layers
def test_layers_match_reference():
    x = rand((2, 5, 16), 0)
    w, b = rand((16, 24), 1), rand((24,), 2)
    tx = torch.from_numpy(x)
    close(TL.linear({"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, tx),
          JL.linear({"w": w, "b": b}, x), 2e-5)
    g = rand((16,), 3)
    close(TL.rmsnorm({"g": torch.from_numpy(g)}, tx),
          JL.rmsnorm({"g": g}, x), 2e-5)
    table = rand((40, 16), 4)
    toks = np.random.default_rng(5).integers(0, 40, (2, 5)).astype(np.int32)
    close(TL.embed({"table": torch.from_numpy(table)}, torch.from_numpy(toks)),
          JL.embed({"table": table}, toks), 0.0 + 1e-12)
    close(TL.unembed({"table": torch.from_numpy(table)}, tx),
          JL.unembed({"table": table}, x), 2e-5)
    ffn = {k: {"w": rand(s, 6 + i, s[0] ** -0.5)} for i, (k, s) in enumerate(
        (("gate", (16, 32)), ("up", (16, 32)), ("down", (32, 16))))}
    tffn = {k: {"w": torch.from_numpy(v["w"])} for k, v in ffn.items()}
    close(TL.swiglu(tffn, tx), JL.swiglu(ffn, x), 2e-5)
    labels = np.random.default_rng(9).integers(-1, 40, (2, 5)).astype(np.int32)
    logits = rand((2, 5, 40), 10)
    close(TL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)),
          JL.cross_entropy(logits, labels), 2e-5)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope_matches_reference(theta):
    x = rand((2, 9, 3, 16), 11)
    pos = np.arange(1000, 1009, dtype=np.int32)[None].repeat(2, 0)
    close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
          JL.apply_rope(x, jnp.asarray(pos), theta), 2e-5)


def test_layer_dtypes_follow_reference():
    """linear casts w to x's dtype; rmsnorm computes in f32 and casts back;
    unembed returns f32."""
    x = torch.from_numpy(rand((2, 3, 8), 12)).to(torch.bfloat16)
    w = torch.from_numpy(rand((8, 4), 13))
    assert TL.linear({"w": w}, x).dtype == torch.bfloat16
    assert TL.rmsnorm({"g": torch.ones(8)}, x).dtype == torch.bfloat16
    assert TL.unembed({"table": w.T.contiguous()}, x).dtype == torch.float32


# -------------------------------------------------------------------- GQA
def _attn_setup(name, seed=0):
    cfg = get_arch(name).reduced()
    jp = JA.gqa_init(jax.random.PRNGKey(seed), cfg)
    if cfg.qkv_bias:       # reference inits biases to zero: make them count
        for k in ("wq", "wk", "wv"):
            jp[k]["b"] = jnp.asarray(rand(jp[k]["b"].shape, 20 + seed))
    return cfg, jp, params_from_numpy(np_tree(jp), "cpu")


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("window", [0, 8])
def test_gqa_forward_matches_reference(name, window):
    cfg, jp, tp = _attn_setup(name)
    x = rand((2, 12, cfg.d_model), 1)
    pos = np.arange(12, dtype=np.int32)[None]
    jy, jc = JA.gqa_forward(cfg, jp, x, jnp.asarray(pos), window=window,
                            backend="xla", return_cache=True)
    ty, tc = TA.gqa_forward(cfg, tp, torch.from_numpy(x), torch.from_numpy(pos),
                            window=window, return_cache=True)
    close(ty, jy, 2e-5)
    close(tc["k"], jc["k"], 2e-5)
    close(tc["v"], jc["v"], 2e-5)


@pytest.mark.parametrize("s,window,quant", [(10, 0, False), (10, 0, True),
                                            (5, 8, False), (13, 8, False),
                                            (16, 8, True)])
def test_gqa_prefill_cache_layouts(s, window, quant):
    """Padded layout, and the ring layout (position p at slot p % window)
    both below and past the window; int8 quantization."""
    cfg = get_arch("llama3.2-1b").reduced()
    k, v = rand((2, s, 2, 16), 2), rand((2, s, 2, 16), 3)
    jc = JA.gqa_prefill_cache(cfg, 24, k, v, window, quant=quant)
    tc = TA.gqa_prefill_cache(cfg, 24, torch.from_numpy(k), torch.from_numpy(v),
                              window, quant=quant)
    assert sorted(tc) == sorted(jc)
    for key in jc:
        close(tc[key], jc[key], 2e-5 if key.endswith("scale") or not quant
              else 1.0)
        assert tc[key].dtype == {jnp.int8: torch.int8}.get(
            jc[key].dtype.type, torch.float32)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("pos,quant,window", [
    (7, False, 0), (23, False, 0), (7, True, 0), (11, False, 8)])
def test_gqa_decode_matches_reference(name, pos, quant, window):
    """One decode step on a filled cache; pos = max_len-1 is the last slot
    (the reference's clamp edge); int8 caches; ring window."""
    cfg, jp, tp = _attn_setup(name, seed=1)
    smax = 24
    k = rand((2, 20, cfg.n_kv_heads, cfg.hd), 4)
    v = rand((2, 20, cfg.n_kv_heads, cfg.hd), 5)
    jcache = JA.gqa_prefill_cache(cfg, smax, k, v, window, quant=quant)
    tcache = TA.gqa_prefill_cache(cfg, smax, torch.from_numpy(k),
                                  torch.from_numpy(v), window, quant=quant)
    before = {n: t.clone() for n, t in tcache.items()}
    x = rand((2, 1, cfg.d_model), 6)
    jy, jc = JA.gqa_decode(cfg, jp, x, jcache, pos, window=window)
    ty, tc = TA.gqa_decode(cfg, tp, torch.from_numpy(x), tcache, pos,
                           window=window)
    close(ty, jy, 2e-5)
    cache_close(tc, jc, 2e-5)
    for n in before:                       # out of place: input untouched
        assert torch.equal(tcache[n], before[n])


def test_gqa_decode_clamps_past_cache_end():
    """A pos past the last slot writes the last slot, as the reference's
    dynamic_update_slice clamps, instead of raising."""
    cfg, jp, tp = _attn_setup("llama3.2-1b", seed=2)
    k = rand((1, 8, cfg.n_kv_heads, cfg.hd), 7)
    jcache = JA.gqa_prefill_cache(cfg, 8, k, k, 0)
    tcache = TA.gqa_prefill_cache(cfg, 8, torch.from_numpy(k),
                                  torch.from_numpy(k), 0)
    x = rand((1, 1, cfg.d_model), 8)
    jy, jc = JA.gqa_decode(cfg, jp, x, jcache, 9)
    ty, tc = TA.gqa_decode(cfg, tp, torch.from_numpy(x), tcache, 9)
    close(ty, jy, 2e-5)
    cache_close(tc, jc, 2e-5)


# ------------------------------------------------------------------ model
@functools.lru_cache(maxsize=None)
def _jax_params(name, dtype="float32"):
    cfg = dataclasses.replace(get_arch(name).reduced(), dtype=dtype)
    return jax.jit(JModel(cfg).init_params)(jax.random.PRNGKey(0))


def _models(name, kv_quant=False):
    cfg = get_arch(name).reduced()
    jm = JModel(cfg, kv_quant=kv_quant)
    jp = _jax_params(name)
    tm = TModel(tget_arch(name).reduced(), device="cpu", kv_quant=kv_quant)
    tp = tm.adopt(params_from_numpy(np_tree(jp), "cpu"))
    return cfg, jm, jp, tm, tp


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_greedy_decode_match_reference(name):
    """prefill, then 16 greedy decode steps: logits and caches within 1e-4
    at every step, tokens identical."""
    cfg, jm, jp, tm, tp = _models(name)
    smax = 40
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9)) \
        .astype(np.int32)
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks)}, smax)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, smax)
    close(tl, jl, 1e-4)
    cache_close(tc, jc, 1e-4)
    jdec = jax.jit(jm.decode_step)
    pos = toks.shape[1]
    for _ in range(16):
        jt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        tt = tl[:, -1].argmax(-1).numpy().astype(np.int32)[:, None]
        assert np.array_equal(jt, tt)
        jl, jc = jdec(jp, jc, jnp.asarray(jt), pos)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tt), pos)
        close(tl, jl, 1e-4)
        pos += 1
    cache_close(tc, jc, 1e-4)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_batch_matches_reference(name):
    """Ragged right-padded batch: each row's logits at its last real token;
    pad K/V left in place past each row's length, as in the reference."""
    cfg, jm, jp, tm, tp = _models(name)
    rng = np.random.default_rng(2)
    lengths = np.array([3, 8, 5], np.int32)
    toks = np.zeros((3, 8), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
    jl, jc = jm.prefill_batch(jp, {"tokens": jnp.asarray(toks),
                                   "lengths": jnp.asarray(lengths)}, 16)
    tl, tc = tm.prefill_batch(tp, {"tokens": torch.from_numpy(toks),
                                   "lengths": torch.from_numpy(lengths)}, 16)
    close(tl, jl, 1e-4)
    cache_close(tc, jc, 1e-4)


def test_kv_quant_model_decode_matches_reference():
    cfg, jm, jp, tm, tp = _models("llama3.2-1b", kv_quant=True)
    toks = np.arange(1, 7, dtype=np.int32)[None]
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 16)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 16)
    close(tl, jl, 1e-4)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), 6)
    tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), 6)
    close(tl, jl, 1e-4)
    assert tc[0]["k"].dtype == torch.int8
    cache_close(tc, jc, 1e-4)


def test_init_params_layout_matches_reference():
    """The port's own random init has the reference's tree, shapes and
    dtypes, and is reproducible from its seed."""
    jp = _jax_params("qwen2-0.5b")
    tm = TModel(tget_arch("qwen2-0.5b").reduced(), device="cpu")
    tp = tm.init_params(seed=3)
    assert jax.tree.structure(jp) == jax.tree.structure(
        jax.tree.map(lambda t: 0, tp))
    for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert tuple(t.shape) == j.shape
    again = TModel(tget_arch("qwen2-0.5b").reduced(), device="cpu") \
        .init_params(seed=3)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp),
                                                 tree_leaves(again)))
    assert len(tm.state_dict()) == len(tree_leaves(tp))


def test_params_from_numpy_keeps_bfloat16():
    jp = _jax_params("llama3.2-1b", "bfloat16")
    tp = params_from_numpy(np_tree(jp), "cpu")
    t, j = tp["embed"]["table"], jp["embed"]["table"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(), np.asarray(j.astype(jnp.float32)))


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "seamless-m4t-medium",
                                  "internvl2-1b"])
def test_build_plan_names_waiting_families(name):
    """The three families the plan once named as waiting -- MLA, the
    encoder-decoder and the VLM -- now build as the reference plans them,
    segment for segment and field by field."""
    got, want = build_plan(tget_arch(name)), JT.build_plan(get_arch(name))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            assert getattr(g, f.name) == getattr(w, f.name), (f.name, g, w)


@pytest.mark.parametrize("name", all_archs())
def test_served_head_dims_are_kernel_head_dims(name):
    """Every registered arch gets its full-size head dims through the
    kernels of its path: attention (K1, K2) at ``cfg.hd`` (an enc-dec's
    cross-attention too), MLA's prefill through K1 at its query-key and
    value dims, the pair (192, 128), and the scan (K3) at its key and value
    dims in bfloat16."""
    cfg = tget_arch(name)
    plan = build_plan(cfg)
    mixers = {s.mixer for s in plan}
    if cfg.mla is not None:
        qk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        assert mixers == {"mla"}
        assert qk != cfg.mla.v_head_dim
        assert (qk, cfg.mla.v_head_dim) in kflash.DIM_PAIRS
    if mixers & {"attn", "hybrid"} or cfg.encoder_layers:
        assert cfg.hd in kflash.HEAD_DIMS and cfg.hd in kdecode.HEAD_DIMS
    scans = []
    if "mlstm" in mixers:
        dk = cfg.ssm.expand * cfg.d_model // cfg.n_heads
        scans.append((dk, dk))
    if "hybrid" in mixers:
        scans.append((cfg.ssm.state_dim, cfg.hd))
    for dk, dv in scans:
        assert dk % 8 == 0 and dv % 8 == 0 and dk <= kscan.MAX_DK


@pytest.mark.parametrize("batched", [False, True])
def test_head_dim_80_model_matches_reference(batched):
    """stablelm-3b's head dim, 80, on its reduced config: prefill (or a
    ragged prefill_batch), then greedy decode steps."""
    cfg = dataclasses.replace(get_arch("stablelm-3b").reduced(), head_dim=80)
    tcfg = dataclasses.replace(tget_arch("stablelm-3b").reduced(), head_dim=80)
    jm = JModel(cfg)
    jp = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    tm = TModel(tcfg, device="cpu")
    tp = tm.adopt(params_from_numpy(np_tree(jp), "cpu"))
    assert tp["segments"][0]["attn"]["wq"]["w"].shape[-1] == 4 * 80
    rng = np.random.default_rng(3)
    if batched:
        lengths = np.array([4, 9, 6], np.int32)
        toks = np.zeros((3, 9), np.int32)
        for i, n in enumerate(lengths):
            toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
        jl, jc = jm.prefill_batch(jp, {"tokens": jnp.asarray(toks),
                                       "lengths": jnp.asarray(lengths)}, 24)
        tl, tc = tm.prefill_batch(tp, {"tokens": torch.from_numpy(toks),
                                       "lengths": torch.from_numpy(lengths)}, 24)
    else:
        toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 24)
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 24)
    close(tl, jl, 1e-4)
    cache_close(tc, jc, 1e-4)
    pos = toks.shape[1]
    for _ in range(6):
        jt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        tt = tl[:, -1].argmax(-1).numpy().astype(np.int32)[:, None]
        assert np.array_equal(jt, tt)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(jt), pos)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tt), pos)
        close(tl, jl, 1e-4)
        pos += 1
    cache_close(tc, jc, 1e-4)
