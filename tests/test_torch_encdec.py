"""The port's encoder-decoder (seamless-m4t-medium) and vision-prefix
(internvl2-1b) paths against the reference package on the same weights and
inputs (float32, CPU, ``.reduced()`` configs): the encoder stack over stub
frames, the cross-attention layer and its cache leaf, and the whole models
through prefill, ragged prefill_batch and greedy decode.  The reference
runs its ``xla`` path.  Layers to 2e-5, model logits and caches to 1e-4,
greedy tokens identical.  Frames and vision embeddings are stubs made from
a seed with numpy, as the reference's ``input_specs`` make them."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models import transformer as JT
from repro.models.transformer import Model as JModel
from repro_torch.configs import get_arch as tget_arch
from repro_torch.launch import serve
from repro_torch.models import transformer as TT
from repro_torch.models.transformer import Model as TModel
from repro_torch.models.weights import params_from_numpy, tree_leaves

SEAMLESS, VLM = "seamless-m4t-medium", "internvl2-1b"


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
        close(t, j, tol)


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    cfg = get_arch(name).reduced()
    jp = jax.jit(JModel(cfg).init_params)(jax.random.PRNGKey(0))
    if cfg.qkv_bias:     # the reference inits biases to zero: make them count
        jp = jax.tree_util.tree_map_with_path(
            lambda path, a: (rand(a.shape, 7 + len(path), 0.1)
                             if getattr(path[-1], "key", None) == "b"
                             else np.asarray(a)), jp)
    return jax.tree.map(np.asarray, jp)


def _models(name):
    cfg = get_arch(name).reduced()
    jp = _jax_params(name)
    tm = TModel(tget_arch(name).reduced(), device="cpu")
    tp = tm.adopt(params_from_numpy(jp, "cpu"))
    return cfg, JModel(cfg), jax.tree.map(jnp.asarray, jp), tm, tp


def _batch(cfg, toks, seed, lengths=None, vision=True):
    """The same batch for both packages: tokens, and the family's stub
    inputs (frames for the enc-dec, vision embeddings for the VLM)."""
    b = toks.shape[0]
    np_batch = {"tokens": toks}
    if lengths is not None:
        np_batch["lengths"] = np.asarray(lengths, np.int32)
    if cfg.encoder_layers:
        np_batch["frames"] = rand((b, cfg.encoder_len, cfg.d_model), seed)
    if cfg.vision_tokens and vision:
        np_batch["vision_embeds"] = rand((b, cfg.vision_tokens, cfg.d_model),
                                         seed + 1)
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(v) for k, v in np_batch.items()})


def _greedy(jm, jp, tm, tp, jl, jc, tl, tc, pos, steps, tol=1e-4):
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


# ------------------------------------------------------- plan and layout
@pytest.mark.parametrize("name", [SEAMLESS, VLM])
def test_plan_init_and_cache_layout_match_reference(name):
    """Plan field by field (full size and reduced); the port's own init has
    the reference's tree, shapes and types, the encoder subtree included;
    cache shapes as the reference's, the cross leaf at ``encoder_len``."""
    for cfg, tcfg in ((get_arch(name), tget_arch(name)),
                      (get_arch(name).reduced(), tget_arch(name).reduced())):
        assert [dataclasses.astuple(s) for s in TT.build_plan(tcfg)] == \
            [dataclasses.astuple(s) for s in JT.build_plan(cfg)]
    cfg, tcfg = get_arch(name).reduced(), tget_arch(name).reduced()
    jp = _jax_params(name)
    tp = TModel(tcfg, device="cpu").init_params(seed=2)
    assert jax.tree.structure(jp) == jax.tree.structure(
        jax.tree.map(lambda t: 0, tp))
    for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == str(j.dtype)
    assert ("encoder" in tp) == bool(cfg.encoder_layers)
    want = jax.eval_shape(lambda: JModel(cfg).init_cache(3, 24))
    got = TModel(tcfg, device="cpu").init_cache(3, 24, device="meta")
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda t: 0, got))
    for t, j in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == str(j.dtype)
    if cfg.encoder_layers:
        assert got[0]["cross_k"].shape == (
            cfg.n_layers, 3, cfg.encoder_len, cfg.n_kv_heads, cfg.hd)


# ---------------------------------------------------------- enc-dec parts
def test_encode_matches_reference():
    """The encoder stack over stub frames: unmasked GQA + SwiGLU layers,
    then the encoder's final norm."""
    cfg, jm, jp, tm, tp = _models(SEAMLESS)
    frames = rand((2, cfg.encoder_len, cfg.d_model), 1)
    close(tm._encode(tp, torch.from_numpy(frames)),
          jm._encode(jp, jnp.asarray(frames)), 2e-5)


@pytest.mark.parametrize("s", [5, 23])
def test_cross_layer_matches_reference(s):
    """One decoder layer with its cross-attention over the encoder's
    output (a query sequence shorter and longer than the encoder's), with
    its cache leaf, then one decode step over the cached encoder K/V."""
    cfg, jm, jp, tm, tp = _models(SEAMLESS)
    tcfg = tm.cfg
    jseg, tseg = JT.build_plan(cfg)[0], TT.build_plan(tcfg)[0]
    assert tseg.cross
    jlp = jax.tree.map(lambda a: a[1], jp["segments"][0])
    tlp = TT._layer(tp["segments"][0], 1)
    enc = rand((2, cfg.encoder_len, cfg.d_model), 2)
    x = rand((2, s, cfg.d_model), 3)
    pos = np.arange(s, dtype=np.int32)[None]
    (jx, _), jc = JT._apply_layer_seq(
        cfg, jseg, jlp, (jnp.asarray(x), 0.0), jnp.asarray(pos),
        backend="xla", want_cache=True, smax=32, enc_out=jnp.asarray(enc))
    tx, tc = TT._apply_layer_seq(tcfg, tseg, tlp, torch.from_numpy(x),
                                 torch.from_numpy(pos), want_cache=True,
                                 smax=32, enc_out=torch.from_numpy(enc))
    close(tx, jx, 2e-5)
    assert sorted(tc) == ["cross_k", "cross_v", "self"]
    cache_close(tc, jc, 2e-5)
    xt = rand((2, 1, cfg.d_model), 4)
    (jy, _), jc = JT._apply_layer_decode(cfg, jseg, jlp, (jnp.asarray(xt), 0.0),
                                         jc, s, backend="xla")
    ty, tc2 = TT._apply_layer_decode(tcfg, tseg, tlp, torch.from_numpy(xt),
                                     tc, s)
    close(ty, jy, 2e-5)
    cache_close(tc2, jc, 2e-5)
    assert tc2["cross_k"] is tc["cross_k"] and tc2["cross_v"] is tc["cross_v"]


# ------------------------------------------------------ enc-dec model
def test_encdec_prefill_and_decode_match_reference():
    """prefill over stub frames, then 8 greedy decode steps: logits and
    caches within 1e-4 at every step, tokens identical; the cross cache
    leaf equals the reference's and no decode step changes it."""
    cfg, jm, jp, tm, tp = _models(SEAMLESS)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9)) \
        .astype(np.int32)
    jb, tb = _batch(cfg, toks, 10)
    jl, jc = jm.prefill(jp, jb, 32)
    tl, tc = tm.prefill(tp, tb, 32)
    close(tl, jl, 1e-4)
    cache_close(tc, jc, 1e-4)
    close(tc[0]["cross_k"], jc[0]["cross_k"], 1e-4)
    before = {n: tc[0][n].clone() for n in ("cross_k", "cross_v")}
    *_, tc_end = _greedy(jm, jp, tm, tp, jl, jc, tl, tc, toks.shape[1], 8)
    for n, t in before.items():
        assert tc_end[0][n] is tc[0][n]
        assert torch.equal(tc_end[0][n], t)


def test_encdec_prefill_batch_matches_reference():
    """Ragged right-padded prompts over their frames, then decode at the
    shared position."""
    cfg, jm, jp, tm, tp = _models(SEAMLESS)
    rng = np.random.default_rng(2)
    lengths = [3, 11, 7]
    toks = np.zeros((3, 11), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
    jb, tb = _batch(cfg, toks, 20, lengths)
    jl, jc = jm.prefill_batch(jp, jb, 32)
    tl, tc = tm.prefill_batch(tp, tb, 32)
    close(tl, jl, 1e-4)
    cache_close(tc, jc, 1e-4)
    _greedy(jm, jp, tm, tp, jl, jc, tl, tc, max(lengths), 4)


def test_encdec_decode_step_does_not_copy_the_cross_cache(monkeypatch):
    """A decode step allocates new tensors for the self-attention cache
    and writes into them, and hands the encoder K/V on as they are: no
    ``empty_like`` of a cross leaf, and the input cache is not written."""
    cfg, _, _, tm, tp = _models(SEAMLESS)
    toks = np.arange(1, 6, dtype=np.int32)[None]
    _, tb = _batch(cfg, toks, 30)
    _, tc = tm.prefill(tp, tb, 24)        # S_max apart from encoder_len
    shapes = []
    empty_like = torch.empty_like

    def spy(t, *a, **kw):
        shapes.append(tuple(t.shape))
        return empty_like(t, *a, **kw)
    monkeypatch.setattr(torch, "empty_like", spy)
    snap = [t.clone() for t in tree_leaves(tc)]
    _, new = tm.decode_step(tp, tc, torch.tensor([[4]]), 5)
    cross = tuple(tc[0]["cross_k"].shape)
    assert shapes and cross not in shapes
    assert all(torch.equal(a, b) for a, b in zip(snap, tree_leaves(tc)))
    assert new[0]["cross_v"] is tc[0]["cross_v"]
    assert not torch.equal(new[0]["self"]["k"], tc[0]["self"]["k"])


def test_serve_stops_on_an_encdec_arch():
    """The engine passes only tokens, as the reference's does, and an
    enc-dec needs frames: ``launch.serve`` stops with a plain error."""
    with pytest.raises(SystemExit, match="frames"):
        serve.main(["--device", "cpu", "--arch", SEAMLESS, "--requests", "1"])


# ------------------------------------------------------------------ VLM
@pytest.mark.parametrize("vision", [True, False])
def test_vlm_prefill_and_decode_match_reference(vision):
    """With the stub vision prefix in place of the first ``vision_tokens``
    token embeddings, and text only."""
    cfg, jm, jp, tm, tp = _models(VLM)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 13)) \
        .astype(np.int32)
    jb, tb = _batch(cfg, toks, 40, vision=vision)
    jl, jc = jm.prefill(jp, jb, 32)
    tl, tc = tm.prefill(tp, tb, 32)
    close(tl, jl, 1e-4)
    cache_close(tc, jc, 1e-4)
    _greedy(jm, jp, tm, tp, jl, jc, tl, tc, toks.shape[1], 6)
    if vision:     # the prefix changes what the text attends to
        tl2, _ = tm.prefill(tp, {"tokens": tb["tokens"]}, 32)
        assert (tl2 - tm.prefill(tp, tb, 32)[0]).abs().max() > 1e-3


@pytest.mark.parametrize("vision", [True, False])
def test_vlm_prefill_batch_matches_reference(vision):
    cfg, jm, jp, tm, tp = _models(VLM)
    rng = np.random.default_rng(4)
    lengths = [10, 16, 12]
    toks = np.zeros((3, 16), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
    jb, tb = _batch(cfg, toks, 50, lengths, vision=vision)
    jl, jc = jm.prefill_batch(jp, jb, 32)
    tl, tc = tm.prefill_batch(tp, tb, 32)
    close(tl, jl, 1e-4)
    cache_close(tc, jc, 1e-4)
    _greedy(jm, jp, tm, tp, jl, jc, tl, tc, max(lengths), 4)


def test_vlm_prompt_shorter_than_the_prefix_takes_the_prefix_length():
    """A prompt shorter than ``vision_tokens`` gives a sequence of the
    prefix's length (the prompt's embeddings are all replaced), as in the
    reference: the logits are the prefix's last position's."""
    cfg, jm, jp, tm, tp = _models(VLM)
    toks = np.arange(1, 6, dtype=np.int32)[None]
    assert toks.shape[1] < cfg.vision_tokens
    jb, tb = _batch(cfg, toks, 60)
    jl, jc = jm.prefill(jp, jb, 16)
    tl, tc = tm.prefill(tp, tb, 16)
    close(tl, jl, 1e-4)
    cache_close(tc, jc, 1e-4)
    other = dict(tb, tokens=torch.from_numpy(toks + 7))
    assert torch.equal(tm.prefill(tp, other, 16)[0], tl)
    _greedy(jm, jp, tm, tp, jl, jc, tl, tc, cfg.vision_tokens, 2)
