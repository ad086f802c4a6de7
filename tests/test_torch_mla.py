"""The port's MLA path (deepseek-v3-671b: multi-head latent attention, MoE
FFN after ``first_k_dense`` dense layers) against the reference package on
the same weights and inputs (float32, CPU, ``.reduced()`` config): the MLA
block's prefill, prefill cache and absorbed-latent decode, the plain
version of K1 at a value dim other than the query-key dim, the whole
model through prefill, ragged prefill_batch and greedy decode, and the
serving engine against a direct loop.  The reference runs its ``xla``
path.  Blocks and attention to 2e-5, model logits and caches to 1e-4,
greedy tokens identical."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.kernels import ops as jops
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.models.transformer import Model as JModel
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core.live import LiveKernel
from repro_torch.core.policies import make_policy
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.models.transformer import Model as TModel
from repro_torch.models.weights import params_from_numpy, tree_leaves
from repro_torch.serving.engine import InferenceEngine, Request

NAME = "deepseek-v3-671b"


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


# ------------------------------------------------------- K1's plain version
@pytest.mark.parametrize("b,s,h,dk,dv", [
    (2, 16, 4, 24, 16),         # the reduced config's MLA dims
    (1, 64, 2, 192, 128),       # deepseek-v3's
    (3, 37, 1, 40, 8),          # one block of 37
])
def test_flash_ref_at_unequal_dims_matches_reference_xla(b, s, h, dk, dv):
    """``grouped_flash_ref`` with v at its own head dim against the
    reference's blocked ``xla`` flash, which MLA's prefill runs."""
    q, k = rand((b, s, h, dk), 1), rand((b, s, h, dk), 2)
    v = rand((b, s, h, dv), 3)
    scale = dk ** -0.5 * 1.3
    out = tref.grouped_flash_ref(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=True, scale=scale)
    assert out.shape == (b, s, h, dv)

    def bh(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, -1))
    want = jops.flash_attention(bh(q), bh(k), bh(v), causal=True, scale=scale,
                                backend="xla")
    close(out, np.asarray(want).reshape(b, h, s, dv).transpose(0, 2, 1, 3),
          2e-5)


def test_flash_kernel_takes_the_mla_pair_and_no_other_unequal_one():
    """K1's dims: equal ones from ``HEAD_DIMS`` and MLA's (192, 128); the
    full-size config's MLA dims are that pair."""
    m = tget_arch(NAME).mla
    assert (m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim) \
        in kflash.DIM_PAIRS
    assert kflash.DIM_PAIRS == ((192, 128),)
    assert 192 not in kflash.HEAD_DIMS


# --------------------------------------------------------------- MLA block
def _cfgs():
    return get_arch(NAME).reduced(), tget_arch(NAME).reduced()


def _mla_params(seed=0):
    cfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, JA.mla_init(jax.random.PRNGKey(seed), cfg))
    for i, n in enumerate(("q_norm", "kv_norm")):   # make the gains count
        jp[n]["g"] = 1.0 + rand(jp[n]["g"].shape, 30 + i, 0.2)
    return cfg, tcfg, jax.tree.map(jnp.asarray, jp), params_from_numpy(jp, "cpu")


@pytest.mark.parametrize("s", [9, 32])
def test_mla_forward_and_prefill_cache_match_reference(s):
    cfg, tcfg, jp, tp = _mla_params()
    x = rand((2, s, cfg.d_model), 1)
    pos = np.arange(s, dtype=np.int32)[None]
    jy, jc = JA.mla_forward(cfg, jp, x, jnp.asarray(pos), backend="xla",
                            return_cache=True)
    ty, tc = TA.mla_forward(tcfg, tp, torch.from_numpy(x),
                            torch.from_numpy(pos), return_cache=True)
    close(ty, jy, 2e-5)
    cache_close(tc, jc, 2e-5)
    close(TA.mla_forward(tcfg, tp, torch.from_numpy(x), torch.from_numpy(pos)),
          jy, 2e-5)
    jpc = JA.mla_prefill_cache(cfg, 40, jc)
    tpc = TA.mla_prefill_cache(tcfg, 40, tc)
    assert sorted(tpc) == ["c", "kr"]
    assert tpc["c"].shape == (2, 40, cfg.mla.kv_lora_rank)
    cache_close(tpc, jpc, 2e-5)


@pytest.mark.parametrize("pos", [9, 23, 30])
def test_mla_decode_matches_reference(pos):
    """One absorbed-latent decode step on a filled latent cache of 24
    rows: mid-cache, the last row, and a pos past the cache end, which
    writes the last row (the reference's dynamic-update-slice clamps) while
    its mask covers every row.  The step writes out of place."""
    cfg, tcfg, jp, tp = _mla_params(1)
    x = rand((2, 20, cfg.d_model), 2)
    p20 = np.arange(20, dtype=np.int32)[None]
    _, jc = JA.mla_forward(cfg, jp, x, jnp.asarray(p20), backend="xla",
                           return_cache=True)
    _, tc = TA.mla_forward(tcfg, tp, torch.from_numpy(x),
                           torch.from_numpy(p20), return_cache=True)
    jc, tc = JA.mla_prefill_cache(cfg, 24, jc), TA.mla_prefill_cache(tcfg, 24, tc)
    before = {n: t.clone() for n, t in tc.items()}
    xt = rand((2, 1, cfg.d_model), 3)
    jy, jnew = JA.mla_decode(cfg, jp, xt, jc, pos)
    ty, tnew = TA.mla_decode(tcfg, tp, torch.from_numpy(xt), tc, pos)
    close(ty, jy, 2e-5)
    cache_close(tnew, jnew, 2e-5)
    for n in before:
        assert torch.equal(tc[n], before[n])
    assert (tnew["c"][:, min(pos, 23)] != tc["c"][:, min(pos, 23)]).any()


def test_mla_decode_writes_into_out():
    cfg, tcfg, jp, tp = _mla_params(2)
    tc = {"c": torch.from_numpy(rand((3, 12, cfg.mla.kv_lora_rank), 4)),
          "kr": torch.from_numpy(rand((3, 12, cfg.mla.qk_rope_head_dim), 5))}
    out = {n: torch.full_like(t, float("nan")) for n, t in tc.items()}
    xt = rand((3, 1, cfg.d_model), 6)
    ty, new = TA.mla_decode(tcfg, tp, torch.from_numpy(xt), tc, 7, out=out)
    jy, jnew = JA.mla_decode(cfg, jp, xt, {n: jnp.asarray(t.numpy())
                                           for n, t in tc.items()}, 7)
    assert all(new[n] is out[n] for n in out)
    close(ty, jy, 2e-5)
    cache_close(out, jnew, 2e-5)


# ------------------------------------------------------------------ model
@functools.lru_cache(maxsize=None)
def _jax_params(name=NAME):
    cfg = get_arch(name).reduced()
    jp = jax.jit(JModel(cfg).init_params)(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jp)


def _models(name=NAME, capacity_factor=None):
    cfg = get_arch(name).reduced()
    jp = _jax_params(name)
    tm = TModel(tget_arch(name).reduced(), device="cpu",
                capacity_factor=capacity_factor)
    tp = tm.adopt(params_from_numpy(jp, "cpu"))
    return cfg, JModel(cfg, capacity_factor=capacity_factor), \
        jax.tree.map(jnp.asarray, jp), tm, tp


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


@pytest.mark.parametrize("reduced", [False, True])
def test_mla_plan_init_and_cache_layout_match_reference(reduced):
    cfg, tcfg = get_arch(NAME), tget_arch(NAME)
    if reduced:
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
    plan = TT.build_plan(tcfg)
    assert [dataclasses.astuple(s) for s in plan] == \
        [dataclasses.astuple(s) for s in JT.build_plan(cfg)]
    assert [(s.n, s.mixer, s.ffn) for s in plan] == [
        (cfg.first_k_dense, "mla", "swiglu"),
        (cfg.n_layers - cfg.first_k_dense, "mla", "moe")]
    if not reduced:
        return
    jp = _jax_params()
    tp = TModel(tcfg, device="cpu").init_params(seed=1)
    assert jax.tree.structure(jp) == jax.tree.structure(
        jax.tree.map(lambda t: 0, tp))
    for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == str(j.dtype)
    want = jax.eval_shape(lambda: JModel(cfg).init_cache(3, 24))
    got = TModel(tcfg, device="cpu").init_cache(3, 24, device="meta")
    for t, j in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == str(j.dtype)
    assert sorted(got[1]) == ["c", "kr"]


def test_mla_model_prefill_and_decode_match_reference():
    """prefill, then 8 greedy decode steps: logits and caches within 1e-4,
    tokens identical."""
    cfg, jm, jp, tm, tp = _models()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 11)) \
        .astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 32)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 32)
    close(tl, jl, 1e-4)
    cache_close(tc, jc, 1e-4)
    _greedy(jm, jp, tm, tp, jl, jc, tl, tc, toks.shape[1], 8)


def test_mla_model_prefill_batch_matches_reference():
    """Ragged right-padded prompts, then decode at the shared position."""
    cfg, jm, jp, tm, tp = _models()
    rng = np.random.default_rng(2)
    lengths = np.array([4, 16, 9], np.int32)
    toks = np.zeros((3, 16), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
    jl, jc = jm.prefill_batch(jp, {"tokens": jnp.asarray(toks),
                                   "lengths": jnp.asarray(lengths)}, 32)
    tl, tc = tm.prefill_batch(tp, {"tokens": torch.from_numpy(toks),
                                   "lengths": torch.from_numpy(lengths)}, 32)
    close(tl, jl, 1e-4)
    cache_close(tc, jc, 1e-4)
    _greedy(jm, jp, tm, tp, jl, jc, tl, tc, int(lengths.max()), 4)


# --------------------------------------------------------------- serving
@pytest.mark.timeout(120)
@pytest.mark.parametrize("name", [NAME, "internvl2-1b"])
def test_engine_matches_direct_decode(name):
    """Engine tokens equal a direct prefill + decode loop, text only (the
    engine passes only tokens, as the reference's does); deepseek at
    capacity factor 64, where no expert overflows, so batch composition
    cannot change a token."""
    cf = 64.0 if name == NAME else None
    _, _, _, model, params = _models(name, capacity_factor=cf)
    prompt = np.arange(1, 9, dtype=np.int32)
    logits, caches = model.prefill(params, {"tokens": torch.from_numpy(prompt[None])}, 48)
    direct = [int(logits[0, -1].argmax())]
    pos = len(prompt)
    while len(direct) < 5:
        logits, caches = model.decode_step(
            params, caches, torch.tensor([[direct[-1]]], dtype=torch.int32), pos)
        direct.append(int(logits[0, -1].argmax()))
        pos += 1
    kernel = LiveKernel(1, make_policy("ufs"))
    engine = InferenceEngine(model, params, kernel, max_batch=2, max_len=48)
    kernel.start()
    engine.start()
    reqs = [engine.submit(Request(prompt=prompt, max_new_tokens=5)),
            engine.submit(Request(prompt=prompt, tier="background",
                                  max_new_tokens=5))]
    for r in reqs:
        assert r.done_event.wait(timeout=60)
    engine.stop()
    kernel.stop()
    assert all(r.ok for r in reqs)
    assert reqs[0].tokens == direct
    assert reqs[1].tokens == direct      # bulk prefill: batch 1, no padding


@pytest.mark.timeout(120)
@pytest.mark.parametrize("name", [NAME, "internvl2-1b"])
def test_serve_runs_on_cpu(name, capsys):
    serve.main(["--device", "cpu", "--arch", name, "--requests", "2",
                "--max-new-tokens", "3"])
    assert "completed 2/2 requests" in capsys.readouterr().out
