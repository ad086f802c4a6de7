"""The port's hybrid path (hymba: attention and SSD heads side by side)
against the reference package on the same weights and inputs (float32,
CPU): the SSD heads, the hybrid plan and layer, and the whole model at
``hymba-1.5b.reduced()`` (window 8, one global and one windowed layer)
through prefill, ragged prefill_batch and decode across the ring's wrap.
The reference runs its ``xla`` path (or its step-by-step scan oracle,
``naive``, for the SSD block).  Blocks to 2e-5, model logits and caches to
1e-4, greedy tokens identical.  The reference semantics the port keeps on
purpose each have a test: a padded batch rolls the ring by its padded
length, pad tokens run through a short row's SSD state, and decode uses one
shared position."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models.transformer import Model as JModel
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core.live import LiveKernel
from repro_torch.core.policies import make_policy
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.transformer import Model as TModel
from repro_torch.models.weights import params_from_numpy, tree_leaves
from repro_torch.serving.engine import InferenceEngine, Request

NAME = "hymba-1.5b"


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


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


def _liven(tree, seed):
    """The reference inits ``a_log`` and biases to zero: give the decay
    rates and the SSD step biases values that make them count."""
    def one(path, a):
        keys = [getattr(k, "key", None) for k in path]
        if keys[-1] == "a_log":
            return rand(a.shape, seed + len(path), 0.5)
        if keys[-1] == "b" and "wdt" in keys:
            return rand(a.shape, seed + 7, 0.5)
        return np.asarray(a)
    return jax.tree_util.tree_map_with_path(one, tree)


def _cfgs():
    return get_arch(NAME).reduced(), tget_arch(NAME).reduced()


# ------------------------------------------------------------ SSD heads
def _ssd_params(seed=0):
    cfg, tcfg = _cfgs()
    jp = _liven(JS.ssd_init(jax.random.PRNGKey(seed), cfg), 40 + seed)
    return cfg, tcfg, jax.tree.map(jnp.asarray, jp), params_from_numpy(jp, "cpu")


@pytest.mark.parametrize("s", [16, 37])
@pytest.mark.parametrize("against", ["naive", "xla"])
def test_ssd_forward_and_decode_match_reference(s, against):
    """Sequence output and final (C, n) state, then three decode steps;
    a decode step writes a new state and keeps the one it read."""
    cfg, tcfg, jp, tp = _ssd_params()
    x = rand((2, s, cfg.d_model), 1)
    jy, jst = JS.ssd_forward(cfg, jp, x, backend=against, return_state=True)
    ty, tst = TS.ssd_forward(tcfg, tp, torch.from_numpy(x), return_state=True)
    close(ty, jy, 2e-5)
    cache_close(tst, jst, 2e-5)
    assert tst["c"].shape == (2, cfg.n_heads, cfg.ssm.state_dim, cfg.hd)
    assert tst["c"].dtype == tst["n"].dtype == torch.float32
    close(TS.ssd_forward(tcfg, tp, torch.from_numpy(x)), jy, 2e-5)
    before = {n: t.clone() for n, t in tst.items()}
    for step in range(3):
        xt = rand((2, 1, cfg.d_model), 2 + step)
        jy, jst = JS.ssd_decode(cfg, jp, xt, jst)
        ty, new = TS.ssd_decode(tcfg, tp, torch.from_numpy(xt), tst)
        close(ty, jy, 2e-5)
        cache_close(new, jst, 2e-5)
        if step == 0:
            for n in before:
                assert torch.equal(tst[n], before[n])
        tst = new


def test_ssd_decode_writes_into_out():
    cfg, tcfg, jp, tp = _ssd_params(1)
    x = rand((3, 9, cfg.d_model), 5)
    _, jst = JS.ssd_forward(cfg, jp, x, backend="naive", return_state=True)
    _, tst = TS.ssd_forward(tcfg, tp, torch.from_numpy(x), return_state=True)
    xt = rand((3, 1, cfg.d_model), 6)
    out = {n: torch.full_like(t, float("nan")) for n, t in tst.items()}
    ty, new = TS.ssd_decode(tcfg, tp, torch.from_numpy(xt), tst, out=out)
    jy, jst = JS.ssd_decode(cfg, jp, xt, jst)
    assert all(new[n] is out[n] for n in out)
    close(ty, jy, 2e-5)
    cache_close(out, jst, 2e-5)


# ------------------------------------------------------- plan and layout
@pytest.mark.parametrize("reduced", [False, True])
def test_hybrid_plan_matches_reference(reduced):
    cfg, tcfg = get_arch(NAME), tget_arch(NAME)
    if reduced:
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
    want = [dataclasses.astuple(s) for s in JT.build_plan(cfg)]
    assert [dataclasses.astuple(s) for s in TT.build_plan(tcfg)] == want
    if not reduced:
        assert [(s.kind, s.n, s.window) for s in TT.build_plan(tcfg)] == [
            ("single", 1, 0), ("scan", 14, 1024), ("single", 1, 0),
            ("scan", 15, 1024), ("single", 1, 0)]


@functools.lru_cache(maxsize=None)
def _jax_params():
    cfg, _ = _cfgs()
    jp = jax.jit(JModel(cfg).init_params)(jax.random.PRNGKey(0))
    return _liven(jp, 60)


def test_hybrid_init_layout_matches_reference():
    """Tree, shapes and types of the port's own init, single layers
    unstacked; ``a_log`` float32 also when the model is bfloat16; cache
    shapes as the reference's."""
    _, tcfg = _cfgs()
    jp = _jax_params()
    tm = TModel(tcfg, device="cpu")
    tp = tm.init_params(seed=2)
    assert jax.tree.structure(jp) == jax.tree.structure(
        jax.tree.map(lambda t: 0, tp))
    for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == str(j.dtype)
    assert tp["segments"][0]["ssd"]["a_log"].shape == (tcfg.n_heads,)
    assert tp["segments"][1]["ssd"]["a_log"].shape == (1, tcfg.n_heads)
    bf = TModel(dataclasses.replace(tcfg, dtype="bfloat16"), device="cpu")
    bp = bf.init_params(seed=2)
    assert bp["segments"][1]["ssd"]["a_log"].dtype == torch.float32
    assert bp["segments"][1]["ssd"]["wv"]["w"].dtype == torch.bfloat16
    jm = JModel(get_arch(NAME).reduced())
    want = jax.eval_shape(lambda: jm.init_cache(3, 24))
    got = tm.init_cache(3, 24, device="meta")
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda t: 0, got))
    for t, j in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == str(j.dtype)


def test_params_from_numpy_keeps_a_log_float32():
    """A cast of the reference's tree to bfloat16 keeps the SSD decay rates
    in float32, as the reference's bfloat16 init has them."""
    jp = _jax_params()
    tp = params_from_numpy(jp, "cpu", dtype="bfloat16")
    assert tp["segments"][0]["ssd"]["a_log"].dtype == torch.float32
    assert tp["segments"][0]["ssd"]["wdt"]["b"].dtype == torch.bfloat16
    assert tp["embed"]["table"].dtype == torch.bfloat16
    close(tp["segments"][0]["ssd"]["a_log"], jp["segments"][0]["ssd"]["a_log"],
          1e-12)


# ----------------------------------------------------------------- layer
@pytest.mark.parametrize("seg_index", [0, 1])
def test_hybrid_layer_matches_reference(seg_index):
    """One global (0) and one windowed (1) layer over a sequence longer
    than the window, with its cache, then one decode step."""
    cfg, tcfg = _cfgs()
    jp = _jax_params()
    tp = params_from_numpy(jp, "cpu")
    jseg = JT.build_plan(cfg)[seg_index]
    tseg = TT.build_plan(tcfg)[seg_index]
    jlp = jax.tree.map(jnp.asarray, jp["segments"][seg_index])
    tlp = tp["segments"][seg_index]
    if jseg.kind == "scan":
        jlp = jax.tree.map(lambda a: a[0], jlp)
        tlp = TT._layer(tlp, 0)
    s, smax = 13, 24
    x = rand((2, s, cfg.d_model), 7)
    pos = np.arange(s, dtype=np.int32)[None]
    (jx, _), jc = JT._apply_layer_seq(cfg, jseg, jlp, (jnp.asarray(x), 0.0),
                                      jnp.asarray(pos), backend="xla",
                                      want_cache=True, smax=smax)
    tx, _, tc = TT._apply_layer_seq(tcfg, tseg, tlp, torch.from_numpy(x),
                                    torch.from_numpy(pos), want_cache=True,
                                    smax=smax)
    close(tx, jx, 2e-5)
    cache_close(tc, jc, 2e-5)
    xt = rand((2, 1, cfg.d_model), 8)
    (jy, _), jc = JT._apply_layer_decode(cfg, jseg, jlp, (jnp.asarray(xt), 0.0),
                                         jc, s, backend="xla")
    ty, tc = TT._apply_layer_decode(tcfg, tseg, tlp, torch.from_numpy(xt),
                                    tc, s)
    close(ty, jy, 2e-5)
    cache_close(tc, jc, 2e-5)


# ----------------------------------------------------------------- model
def _models(kv_quant=False):
    cfg, tcfg = _cfgs()
    jp = _jax_params()
    tm = TModel(tcfg, device="cpu", kv_quant=kv_quant)
    tp = tm.adopt(params_from_numpy(jp, "cpu"))
    return cfg, JModel(cfg, kv_quant=kv_quant), \
        jax.tree.map(jnp.asarray, jp), tm, tp


def _greedy(jm, jp, tm, tp, jl, jc, tl, tc, pos, steps, tol=1e-4):
    """``steps`` greedy decode steps at the shared position ``pos`` on both
    packages; logits within ``tol`` and tokens identical at every step."""
    for _ in range(steps):
        jt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        tt = tl[:, -1].argmax(-1).numpy().astype(np.int32)[:, None]
        assert np.array_equal(jt, tt)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(jt), pos)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tt), pos)
        close(tl, jl, tol)
        pos += 1
    cache_close(tc, jc, tol)
    return jl, jc, tl, tc


@pytest.mark.parametrize("s", [5, 11])
def test_hybrid_prefill_and_decode_across_ring_wrap_match_reference(s):
    """A prompt shorter (5) and longer (11) than the window of 8, then 10
    greedy steps: the windowed layer's ring wraps, the global layer's
    cache does not."""
    cfg, jm, jp, tm, tp = _models()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, s)) \
        .astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 32)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 32)
    close(tl, jl, 1e-4)
    cache_close(tc, jc, 1e-4)
    assert tc[1]["kv"]["k"].shape[2] == cfg.sliding_window
    assert tc[0]["kv"]["k"].shape[1] == 32
    _greedy(jm, jp, tm, tp, jl, jc, tl, tc, s, 10)


def _ragged(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lengths), max(lengths)), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
    return toks, np.asarray(lengths, np.int32)


def test_hybrid_prefill_batch_and_shared_pos_decode_match_reference():
    """Ragged right-padded prompts padded past the window, then decode at
    the one shared position (the longest row's), as the engine runs it:
    the short rows write and read at that position, as in the
    reference."""
    cfg, jm, jp, tm, tp = _models()
    toks, lengths = _ragged(cfg, [3, 12, 9], 2)
    jl, jc = jm.prefill_batch(jp, {"tokens": jnp.asarray(toks),
                                   "lengths": jnp.asarray(lengths)}, 32)
    tl, tc = tm.prefill_batch(tp, {"tokens": torch.from_numpy(toks),
                                   "lengths": torch.from_numpy(lengths)}, 32)
    close(tl, jl, 1e-4)
    cache_close(tc, jc, 1e-4)
    _greedy(jm, jp, tm, tp, jl, jc, tl, tc, int(lengths.max()), 6)


def test_prefill_batch_rolls_the_ring_by_the_padded_length():
    """A row of 3 tokens padded to 12 (past the window of 8): its ring holds
    positions 4-11 (pad tokens) rolled by 12 % 8, as the reference's
    ``gqa_prefill_cache`` places them, and not its own 3 tokens as its
    unbatched prefill does."""
    cfg, jm, jp, tm, tp = _models()
    toks, lengths = _ragged(cfg, [3, 12], 3)
    _, jc = jm.prefill_batch(jp, {"tokens": jnp.asarray(toks),
                                  "lengths": jnp.asarray(lengths)}, 16)
    _, tc = tm.prefill_batch(tp, {"tokens": torch.from_numpy(toks),
                                  "lengths": torch.from_numpy(lengths)}, 16)
    cache_close(tc, jc, 1e-4)
    ring = tc[1]["kv"]["k"][0, 0]                        # (W, KH, hd)
    _, alone = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:1, :3])}, 16)
    own = alone[1]["kv"]["k"][0, 0]
    assert (own[3:] == 0).all()                          # padded, not rolled
    assert (ring != 0).any(dim=-1).all()                 # every slot a pad's K
    assert (ring[:3] - own[:3]).abs().max() > 1e-3       # its own K are gone
    _, whole = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:1])}, 16)
    assert (ring - whole[1]["kv"]["k"][0, 0]).abs().max() < 1e-5


def test_hybrid_prefill_batch_runs_pads_through_ssd_state_as_in_reference():
    """The pad tokens run through a short row's SSD state, as in the
    reference: the states equal the reference's and differ from the row's
    unbatched prefill; a full-length row's state equals its own."""
    cfg, jm, jp, tm, tp = _models()
    toks, lengths = _ragged(cfg, [3, 8, 5], 4)
    jl, jc = jm.prefill_batch(jp, {"tokens": jnp.asarray(toks),
                                   "lengths": jnp.asarray(lengths)}, 16)
    tl, tc = tm.prefill_batch(tp, {"tokens": torch.from_numpy(toks),
                                   "lengths": torch.from_numpy(lengths)}, 16)
    close(tl, jl, 1e-4)
    cache_close(tc, jc, 1e-4)
    _, alone = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:1, :3])}, 16)
    _, full = tm.prefill(tp, {"tokens": torch.from_numpy(toks[1:2])}, 16)
    for seg in (0, 1):          # a single layer, then a stacked one
        def row(caches, i):
            c = caches[seg]["ssd"]["c"]
            return c[i] if seg == 0 else c[:, i]
        assert (row(alone, 0) - row(tc, 0)).abs().max() > 1e-3
        assert (row(full, 0) - row(tc, 1)).abs().max() < 1e-5


def test_hybrid_kv_quant_matches_reference():
    """int8 K/V where the reference quantizes them: the prefill cache's
    attention part; decode reads and writes it quantized."""
    cfg, jm, jp, tm, tp = _models(kv_quant=True)
    toks = np.arange(1, 11, dtype=np.int32)[None]
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 16)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 16)
    close(tl, jl, 1e-4)
    assert tc[1]["kv"]["k"].dtype == torch.int8
    assert tm.init_cache(1, 16)[1]["kv"]["k"].dtype == torch.float32
    _greedy(jm, jp, tm, tp, jl, jc, tl, tc, toks.shape[1], 2)


@pytest.mark.timeout(120)
def test_hybrid_engine_matches_direct_decode():
    """A prompt of one whole length bucket (16 tokens, twice the window)
    enters no pad token: the engine's tokens equal a direct loop's."""
    _, _, _, model, params = _models()
    prompt = np.arange(3, 19, dtype=np.int32)
    logits, caches = model.prefill(params, {"tokens": torch.from_numpy(prompt[None])}, 48)
    direct = [int(logits[0, -1].argmax())]
    pos = len(prompt)
    while len(direct) < 6:
        logits, caches = model.decode_step(
            params, caches, torch.tensor([[direct[-1]]], dtype=torch.int32), pos)
        direct.append(int(logits[0, -1].argmax()))
        pos += 1
    kernel = LiveKernel(1, make_policy("ufs"))
    engine = InferenceEngine(model, params, kernel, max_batch=2, max_len=48)
    kernel.start()
    engine.start()
    reqs = [engine.submit(Request(prompt=prompt, max_new_tokens=6)),
            engine.submit(Request(prompt=prompt, tier="background",
                                  max_new_tokens=6))]
    for r in reqs:
        assert r.done_event.wait(timeout=60)
    engine.stop()
    kernel.stop()
    assert all(r.ok for r in reqs)
    assert reqs[0].tokens == direct
    assert reqs[1].tokens == direct      # bulk prefill: batch 1, no padding
