"""The port's MoE path against the reference package on the same weights and
inputs (float32, CPU): the router's plain version (K4) against the
reference oracle and the Pallas kernel in interpret mode, its dispatch plan
against the reference's sort rule, ``moe_forward`` with drops at capacity,
and the whole qwen2-moe model at a reduced size with padded experts.
Router indices, slots and counts equal, weights to 1e-6 (the bound of
tests/test_kernels.py), probability sums to 1e-5 relative, layers and the
aux loss to 2e-5, model logits to 1e-4, greedy tokens identical."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_arch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import moe as JM
from repro.models.transformer import Model as JModel
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core.live import LiveKernel
from repro_torch.core.policies import make_policy
from repro_torch.kernels import moe_topk as kmoe
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import moe as TM
from repro_torch.models.transformer import Model as TModel
from repro_torch.models.weights import params_from_numpy, tree_leaves
from repro_torch.serving.engine import InferenceEngine, Request


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


# ----------------------------------------------------------------- router
ROUTER_SHAPES = [(512, 64, 4, 60), (256, 256, 8, 256), (128, 16, 2, 16)]


def _logits(t, e, seed, dtype):
    x = rand((t, e), seed)
    if dtype == "bfloat16":
        x = np.round(x * 2) / 2          # few distinct values: forced ties
    return x


@pytest.mark.parametrize("t,e,k,n_valid", ROUTER_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_plain_matches_reference(t, e, k, n_valid, dtype):
    """Against the oracle and the Pallas kernel in interpret mode; bfloat16
    logits rounded to halves tie often, and ties go to the lowest index."""
    x = _logits(t, e, 1, dtype)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    rw, ri = jref.moe_topk_ref(jx, k, n_valid=n_valid)
    pw, pi = jops.moe_topk(jx, k, n_valid=n_valid, backend="interpret")
    tw, ti = tops.moe_topk(tx, k, n_valid=n_valid)
    assert ti.dtype == torch.int32 and tw.dtype == torch.float32
    for w, i in ((rw, ri), (pw, pi)):
        assert np.array_equal(ti.numpy(), np.asarray(i))
        close(tw, w, 1e-6)


def test_router_ties_go_to_lowest_index():
    x = np.zeros((3, 16), np.float32)
    x[1, [3, 7, 9]] = 1.0
    x[2, 10:] = 2.0
    w, i = tref.moe_topk_ref(torch.from_numpy(x), 3, n_valid=12)
    assert i.tolist() == [[0, 1, 2], [3, 7, 9], [10, 11, 0]]
    jw, ji = jref.moe_topk_ref(jnp.asarray(x), 3, n_valid=12)
    assert np.array_equal(i.numpy(), np.asarray(ji))
    close(w, jw, 1e-6)


@pytest.mark.parametrize("t", [1, 37, 500])
def test_router_plain_takes_any_token_count(t):
    """The Pallas kernel asserts a block multiple; the port's router does
    not (bulk prefill passes raw prompt lengths)."""
    x = rand((t, 64), 2)
    rw, ri = jref.moe_topk_ref(jnp.asarray(x), 4, n_valid=60)
    tw, ti = tops.moe_topk(torch.from_numpy(x), 4, n_valid=60)
    assert np.array_equal(ti.numpy(), np.asarray(ri))
    close(tw, rw, 1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_router_invariants(seed):
    """Weights sum to 1; indices unique per token and below n_valid."""
    rng = np.random.default_rng(seed)
    e = int(rng.integers(4, 65))
    k = int(rng.integers(1, min(4, e) + 1))
    n_valid = max(k, e - int(rng.integers(0, 4)))
    w, i = tops.moe_topk(torch.from_numpy(rand((int(rng.integers(1, 65)), e),
                                                seed)), k, n_valid=n_valid)
    assert torch.allclose(w.sum(-1), torch.ones(w.shape[0]), atol=1e-5)
    assert int(i.max()) < n_valid
    assert all(len(set(row)) == k for row in i.tolist())


def test_router_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        kmoe.moe_topk(torch.zeros((4, 16)), 2)


def test_router_dispatch_by_device():
    x = torch.from_numpy(rand((8, 16), 3))
    w, i = tops.moe_topk(x, 2)
    rw, ri = tref.moe_topk_ref(x, 2)
    assert torch.equal(w, rw) and torch.equal(i, ri)
    with pytest.raises(ValueError, match="no path"):
        tops.moe_topk(x.to("meta"), 2)


# ------------------------------------------------------- dispatch plan
ROUTE_SHAPES = [(8, 1, 8), (16, 2, 12), (64, 4, 60), (256, 8, 256)]


def _reference_plan(idx, e, cap):
    """The reference's rule (models/moe.py) on the same indices: JAX's
    stable argsort of the pairs by expert, bincount and cumsum for each
    run's start.  Returns slot (T, k) as ``Route`` has it, slot_tok (E, C)
    and counts (E,) as numpy."""
    t, k = idx.shape
    flat = idx.reshape(-1)
    order = np.asarray(jnp.argsort(jnp.asarray(flat)))
    eid_s = flat[order]
    group = np.bincount(eid_s, minlength=e)
    pos_s = np.arange(t * k) - (np.cumsum(group) - group)[eid_s]
    keep_s = pos_s < cap
    slot = np.empty(t * k, np.int64)
    slot[order] = np.where(keep_s, eid_s * cap + pos_s, e * cap)
    slot_tok = np.full((e, cap), t, np.int64)
    slot_tok[eid_s[keep_s], pos_s[keep_s]] = order[keep_s] // k
    return slot.reshape(t, k), slot_tok, group


def _route_capacities(t, e, k):
    """One that drops, the prefill default, and one that drops nothing."""
    return sorted({TM.capacity(t, k, cf, e) for cf in (0.5, 1.25)} | {t})


@pytest.mark.parametrize("e,k,n_valid", ROUTE_SHAPES)
@pytest.mark.parametrize("t", [1, 3, 8, 37, 500, 2048])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_plain_matches_reference_rule(dtype, t, e, k, n_valid):
    """Slots, kept pairs, slot tokens and counts identical to the
    reference's sort rule; weights to 1e-6 of the oracle times the scale;
    probability sums to 1e-5 relative of JAX's softmax summed.  bfloat16
    logits rounded to halves tie often."""
    x = _logits(t, e, 11, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(jnp.dtype(dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(jnp.where(jnp.arange(e) < n_valid, jx, -1e30), -1)
    want_sum = np.asarray(jnp.sum(probs, axis=0))
    rw, _ = jref.moe_topk_ref(jx, k, n_valid=n_valid)
    for cap in _route_capacities(t, e, k):
        r = tops.moe_route(tx, k, capacity=cap, n_valid=n_valid,
                           router_scale=2.5)
        assert [v.dtype for v in r] == [torch.float32] + [torch.int32] * 3 + \
            [torch.float32, torch.int32]
        slot, slot_tok, counts = _reference_plan(r.idx.numpy(), e, cap)
        assert np.array_equal(r.slot.numpy(), slot)
        assert np.array_equal(r.slot_tok.numpy(), slot_tok)
        assert np.array_equal(r.counts.numpy(), counts)
        close(r.weights, np.asarray(rw) * 2.5, 1e-6)
        got = r.prob_sum.numpy()
        assert np.all(np.abs(got - want_sum) <= 1e-5 * np.abs(want_sum))
        if cap == TM.capacity(t, k, 0.5, e) and t * k > e:
            assert (r.slot == e * cap).any(), "this capacity must drop pairs"
        assert not (r.slot == e * cap).any() or cap < t


@pytest.mark.parametrize("tokens_per_block", [1, 7, 32, 128, 500, "plan"])
@pytest.mark.parametrize("t,e,k,n_valid", [(37, 16, 2, 12), (500, 64, 4, 60),
                                           (2048, 64, 4, 60), (300, 256, 8, 256)])
def test_route_blocked_arithmetic_matches_plain(t, e, k, n_valid,
                                                tokens_per_block):
    """The kernel's arithmetic (ranks in blocks of tokens, then a prefix of
    the blocks' counts) gives the sort's plan for any block size, a last
    block cut short included; "plan" is the block size the kernel takes."""
    if tokens_per_block == "plan":
        tokens_per_block = kmoe.route_plan(t, e).tokens_per_block
    x = torch.from_numpy(_logits(t, e, 12, "bfloat16")).to(torch.bfloat16)
    for cap in _route_capacities(t, e, k):
        want = tref.moe_route_ref(x, k, capacity=cap, n_valid=n_valid)
        got = tref.moe_route_blocked_ref(x, k, capacity=cap, n_valid=n_valid,
                                         tokens_per_block=tokens_per_block)
        for name in ("weights", "idx", "slot", "slot_tok", "counts"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert torch.allclose(got.prob_sum, want.prob_sum, rtol=1e-5, atol=0)


@pytest.mark.parametrize("t,e", [(0, 64), (1, 64), (8, 64), (8, 256), (37, 16),
                                 (500, 64), (2048, 64), (2048, 256),
                                 (8192, 64), (100000, 8)])
def test_route_plan_covers_every_token_in_one_cluster(t, e):
    """At most 16 blocks (one cluster) of at most 512 threads, every token in
    a block; a token's lanes hold all experts in at most one warp.  Decode
    (8 tokens, 64 experts) takes a warp a token in one block; prefill
    (2048) 16 blocks of 128 tokens at 4 lanes a token."""
    plan = kmoe.route_plan(t, e)
    g = kmoe.group_lanes(e, plan.values_per_lane)
    assert 1 <= plan.blocks <= kmoe.MAX_BLOCKS
    assert plan.blocks * plan.tokens_per_block >= t
    assert (plan.blocks - 1) * plan.tokens_per_block < max(t, 1)
    assert g * plan.values_per_lane >= e and g <= 32
    assert plan.values_per_lane in (2, 4, 8, 16)
    if (t, e) == (8, 64):
        assert plan == kmoe.Plan(1, 8, 2) and g == 32
    if (t, e) == (2048, 64):
        assert plan == kmoe.Plan(16, 128, 16) and g == 4


def test_route_wrapper_refuses_cpu_tensors_and_dispatches_by_device():
    with pytest.raises(ValueError, match="CUDA"):
        kmoe.moe_route(torch.zeros((4, 16)), 2, capacity=1)
    x = torch.from_numpy(rand((8, 16), 3))
    got = tops.moe_route(x, 2, capacity=2)
    want = tref.moe_route_ref(x, 2, capacity=2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="no path"):
        tops.moe_route(x.to("meta"), 2, capacity=2)


# ------------------------------------------------------------- moe layer
def _moe_cfg(n_routed=6, padded=8, top_k=2, n_shared=1):
    base = get_arch("qwen2-moe-a2.7b").reduced()
    moe = dataclasses.replace(base.moe, n_routed=n_routed, padded_routed=padded,
                              top_k=top_k, n_shared=n_shared)
    return dataclasses.replace(base, moe=moe)


def _moe_params(cfg, seed=0, router_scale=1.0):
    jp = JM.moe_init(jax.random.PRNGKey(seed), cfg)
    # a router spread wide enough that experts fill up and drop tokens
    jp["router"]["w"] = jnp.asarray(rand(jp["router"]["w"].shape, 40 + seed,
                                         router_scale))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _routed_pairs_kept(cfg, x, jp, cf):
    """How many (token, choice) pairs the reference keeps, by its rule."""
    m = cfg.moe
    xf = np.asarray(x).reshape(-1, cfg.d_model)
    _, idx = jref.moe_topk_ref(jnp.asarray(xf @ np.asarray(jp["router"]["w"])),
                               m.top_k, n_valid=m.n_routed)
    t = xf.shape[0]
    cap = TM.capacity(t, m.top_k, cf, m.routed_total())
    counts = np.bincount(np.asarray(idx).reshape(-1), minlength=m.routed_total())
    return int(np.minimum(counts, cap).sum()), t * m.top_k, cap


@pytest.mark.parametrize("b,s,cf", [(2, 16, 1.25), (2, 16, 0.5), (3, 5, 2.0),
                                    (1, 37, 1.0)])
def test_moe_forward_with_drops_matches_reference(b, s, cf):
    """Capacity, the stable sort and the zero scatter of dropped pairs pick
    the same tokens as the reference: outputs and aux loss to 2e-5."""
    cfg = _moe_cfg()
    jp, tp = _moe_params(cfg)
    x = rand((b, s, cfg.d_model), 5)
    kept, pairs, _ = _routed_pairs_kept(cfg, x, jp, cf)
    if cf < 1.25:
        assert kept < pairs, "this case must drop tokens"
    jy, jaux = JM.moe_forward(cfg, jp, x, capacity_factor=cf, backend="xla")
    ty, taux = TM.moe_forward(cfg, tp, torch.from_numpy(x), capacity_factor=cf)
    close(ty, jy, 2e-5)
    close(taux, jaux, 2e-5)


@pytest.mark.parametrize("t,k,cf,e", [(8, 4, 2.0, 64), (2048, 4, 1.25, 64),
                                      (500, 4, 1.25, 64), (3, 2, 1.25, 8),
                                      (10, 2, 0.5, 8), (1, 1, 0.1, 64)])
def test_capacity_is_the_reference_expression(t, k, cf, e):
    """Python's round on the same float expression: 8 decode rows at cf 2
    over 64 experts keep 1 slot each; 500 bulk tokens keep 39."""
    want = int(max(1, round(t * k * cf / e)))
    assert TM.capacity(t, k, cf, e) == want
    if (t, e) == (8, 64):
        assert want == 1
    if t == 500:
        assert want == 39


def test_decode_batch_of_8_keeps_one_token_per_expert():
    """A decode step at B = 8 over 64 padded experts (60 routed, top 4) at
    the decode capacity factor 2.0 has one slot per expert, so every token
    routed to a busy expert after the first is dropped, as in the
    reference."""
    cfg = _moe_cfg(n_routed=60, padded=64, top_k=4)
    jp, tp = _moe_params(cfg, seed=1)
    x = rand((8, 1, cfg.d_model), 6)
    kept, pairs, cap = _routed_pairs_kept(cfg, x, jp, 2.0)
    assert cap == 1 and kept < pairs
    jy, _ = JM.moe_forward(cfg, jp, x, capacity_factor=2.0, backend="xla")
    ty, _ = TM.moe_forward(cfg, tp, torch.from_numpy(x), capacity_factor=2.0)
    close(ty, jy, 2e-5)


@pytest.mark.parametrize("b,s,cf", [(4, 125, 1.25), (2, 64, 0.5), (8, 1, 2.0)])
def test_moe_aux_loss_from_route_sums_matches_reference(b, s, cf):
    """The aux loss from the router's probability sums and counts against
    JAX's softmax mean and one-hot mean, 60 experts padded to 64, top 4."""
    cfg = _moe_cfg(n_routed=60, padded=64, top_k=4)
    jp, tp = _moe_params(cfg, seed=2)
    x = rand((b, s, cfg.d_model), 8)
    _, jaux = JM.moe_forward(cfg, jp, x, capacity_factor=cf, backend="xla")
    _, taux = TM.moe_forward(cfg, tp, torch.from_numpy(x), capacity_factor=cf)
    assert taux.dtype == torch.float32 and taux.shape == ()
    close(taux, jaux, 2e-5)


def test_dropped_pair_adds_exactly_zero_where_expert_rows_are_not_finite():
    """NaN expert weights make every output row of those experts NaN.  A
    token whose pair to such an expert was dropped still gets a finite
    output, equal to the reference's (its ``where``), and exactly the NaN
    rows of the reference are NaN."""
    cfg = _moe_cfg()
    jp, tp = _moe_params(cfg)
    x = rand((2, 16, cfg.d_model), 5)
    cf = 0.5
    r = tops.moe_route(torch.from_numpy(x).reshape(-1, cfg.d_model)
                       @ tp["router"]["w"], cfg.moe.top_k, capacity=TM.capacity(
                           32, cfg.moe.top_k, cf, cfg.moe.routed_total()),
                       n_valid=cfg.moe.n_routed)
    e_cap = r.slot_tok.numel()
    dropped = r.slot == e_cap
    busiest = int(torch.bincount(r.idx[dropped].long()).argmax())
    bad = sorted({0, busiest})              # expert 0 holds flat row 0 too
    down = np.asarray(jp["experts"]["down"]).copy()
    down[bad] = np.nan
    jp["experts"]["down"] = jnp.asarray(down)
    tp["experts"]["down"] = torch.from_numpy(down)
    jy, _ = JM.moe_forward(cfg, jp, x, capacity_factor=cf, backend="xla")
    ty, _ = TM.moe_forward(cfg, tp, torch.from_numpy(x), capacity_factor=cf)
    jy = np.asarray(jy).reshape(32, -1)
    ty = ty.reshape(32, -1).numpy()
    assert np.array_equal(np.isnan(ty), np.isnan(jy))
    kept_bad = np.isin(r.idx.numpy(), bad) & ~dropped.numpy()
    dropped_bad = np.isin(r.idx.numpy(), bad) & dropped.numpy()
    spared = dropped_bad.any(1) & ~kept_bad.any(1)
    assert spared.any(), "some token must drop its pair to a NaN expert"
    assert np.isfinite(ty[spared]).all()
    assert np.isnan(ty[kept_bad.any(1)]).all()
    fin = np.isfinite(jy)
    assert float(np.max(np.abs(ty[fin] - jy[fin]))) < 2e-5


class _AtenOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_moe_forward_runs_no_sort_or_scatter(monkeypatch):
    """Around the router (whose plain version sorts by the reference's rule)
    the layer gathers and multiplies: no sort, search, scatter or
    accumulating index op, on the decode shape (8 tokens, top 4 of 60
    experts padded to 64, one slot an expert)."""
    cfg = _moe_cfg(n_routed=60, padded=64, top_k=4)
    _, tp = _moe_params(cfg, seed=1)
    x = torch.from_numpy(rand((8, 1, cfg.d_model), 6))
    want, _ = TM.moe_forward(cfg, tp, x, capacity_factor=2.0)
    route = tops.moe_route(x.reshape(8, -1) @ tp["router"]["w"], 4,
                           capacity=1, n_valid=60)
    monkeypatch.setattr(tops, "moe_route", lambda *a, **kw: route)
    with _AtenOps() as seen:
        y, _ = TM.moe_forward(cfg, tp, x, capacity_factor=2.0)
    assert torch.equal(y, want)
    assert {"index_select", "bmm"} <= seen.names
    banned = {"sort", "argsort", "searchsorted", "index_put", "index_put_",
              "index_add", "index_add_", "scatter", "scatter_", "scatter_add",
              "scatter_add_", "bincount"}
    assert not banned & seen.names, sorted(seen.names)


def test_moe_forward_bfloat16_runs_in_input_dtype():
    cfg = _moe_cfg()
    _, tp = _moe_params(cfg)
    x = torch.from_numpy(rand((2, 8, cfg.d_model), 7)).to(torch.bfloat16)
    y, aux = TM.moe_forward(cfg, tp, x)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert torch.isfinite(y.float()).all()


# ------------------------------------------------------------------ model
def _model_cfgs():
    """qwen2-moe reduced with 6 routed experts padded to 8 (the stock
    reduced config has no padding)."""
    moe = dict(n_routed=6, padded_routed=8)
    j = get_arch("qwen2-moe-a2.7b").reduced()
    t = tget_arch("qwen2-moe-a2.7b").reduced()
    return (dataclasses.replace(j, moe=dataclasses.replace(j.moe, **moe)),
            dataclasses.replace(t, moe=dataclasses.replace(t.moe, **moe)))


@functools.lru_cache(maxsize=None)
def _jax_params():
    cfg, _ = _model_cfgs()
    return jax.jit(JModel(cfg).init_params)(jax.random.PRNGKey(0))


def _models(capacity_factor=None):
    jcfg, tcfg = _model_cfgs()
    jp = _jax_params()
    tm = TModel(tcfg, device="cpu", capacity_factor=capacity_factor)
    tp = tm.adopt(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    return jcfg, JModel(jcfg, capacity_factor=capacity_factor), jp, tm, tp


def test_moe_model_plan_and_init_layout():
    jcfg, tcfg = _model_cfgs()
    assert tcfg.moe.routed_total() > tcfg.moe.n_routed
    tm = TModel(tcfg, device="cpu")
    assert [(s.kind, s.n, s.mixer, s.ffn) for s in tm.plan] == \
        [("scan", tcfg.n_layers, "attn", "moe")]
    tp = tm.init_params(seed=2)
    jp = _jax_params()
    assert jax.tree.structure(jp) == jax.tree.structure(
        jax.tree.map(lambda t: 0, tp))
    for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
    assert tp["segments"][0]["ffn"]["experts"]["gate"].shape == (
        tcfg.n_layers, 8, tcfg.d_model, tcfg.moe.expert_ff)


def test_moe_model_prefill_and_decode_match_reference():
    """prefill, then 4 greedy decode steps at the default capacity factors
    (1.25 for the sequence, 2.0 for decode)."""
    cfg, jm, jp, tm, tp = _models()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9)) \
        .astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 24)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 24)
    close(tl, jl, 1e-4)
    cache_close(tc, jc, 1e-4)
    pos = toks.shape[1]
    for _ in range(4):
        jt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        tt = tl[:, -1].argmax(-1).numpy().astype(np.int32)[:, None]
        assert np.array_equal(jt, tt)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(jt), pos)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tt), pos)
        close(tl, jl, 1e-4)
        pos += 1
    cache_close(tc, jc, 1e-4)


@pytest.mark.parametrize("capacity_factor", [None, 0.25])
def test_moe_prefill_batch_pads_take_capacity_as_in_reference(capacity_factor):
    """Batched admission: pad tokens of short rows go through the router
    and take expert slots, as in the reference.  With a small capacity
    factor that changes a row's logits against its own unbatched prefill;
    the port follows the reference either way."""
    cfg, jm, jp, tm, tp = _models(capacity_factor)
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
    if capacity_factor is not None:
        alone, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:1, :3])}, 16)
        assert (alone[0, -1] - tl[0, 0]).abs().max() > 1e-3


@pytest.mark.timeout(120)
def test_moe_engine_matches_direct_decode():
    """Engine tokens equal a direct prefill + decode loop when no expert
    overflows (capacity factor 64), so batch composition cannot change a
    token."""
    _, _, _, model, params = _models(capacity_factor=64.0)
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
            engine.submit(Request(prompt=prompt[:5], max_new_tokens=5))]
    for r in reqs:
        assert r.done_event.wait(timeout=60)
    engine.stop()
    kernel.stop()
    assert all(r.ok for r in reqs)
    assert reqs[0].tokens == direct
