"""The port's xLSTM path against the reference package on the same weights
and inputs (float32, CPU): the chunkwise mLSTM scan's plain version (K3)
against the reference's step-by-step oracle, its chunkwise ``xla`` path and
the Pallas kernel in interpret mode; the mLSTM and sLSTM blocks; and the
whole xlstm model at a reduced size that still has sLSTM blocks.  The scan
to 1e-3 (the bound of tests/test_kernels.py for chunkwise against the
recurrence), blocks to 2e-5, model logits and states to 1e-4, greedy
tokens identical."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as JS
from repro.models.transformer import Model as JModel
from repro_torch.configs import get_arch as tget_arch
from repro_torch.core.live import LiveKernel
from repro_torch.core.policies import make_policy
from repro_torch.kernels import mlstm_scan as kscan
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import ssm as TS
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


def scan_inputs(bh, s, dk, dv, seed=0):
    """The reference test's inputs: q, k at 0.5, gates from normal logits."""
    q, k = rand((bh, s, dk), seed + 1, 0.5), rand((bh, s, dk), seed + 2, 0.5)
    v = rand((bh, s, dv), seed + 3)
    logf = np.asarray(jax.nn.log_sigmoid(rand((bh, s), seed + 4) + 2.0))
    i = np.asarray(jax.nn.sigmoid(rand((bh, s), seed + 5)))
    return q, k, v, logf, i


def torch_of(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ------------------------------------------------------------------- scan
@pytest.mark.parametrize("bh,s,dk,dv", [(2, 256, 32, 32), (4, 128, 16, 64),
                                        (1, 512, 64, 64)])
@pytest.mark.parametrize("against", ["ref", "xla", "interpret"])
def test_scan_plain_matches_reference(bh, s, dk, dv, against):
    """The port's chunkwise plain version (chunk 64, as the reference test
    runs) against the recurrence, the reference's chunkwise xla path and
    the Pallas kernel in interpret mode."""
    arrs = scan_inputs(bh, s, dk, dv)
    if against == "ref":
        r = jref.mlstm_scan_ref(*arrs)
    else:
        r = jops.mlstm_scan(*arrs, backend=against, chunk=64)
    o = tref.mlstm_chunkwise_ref(*torch_of(*arrs), chunk=64)
    assert o.shape == (bh, s, dv)
    close(o, r, 1e-3)


@pytest.mark.parametrize("bh,s,dk,dv,chunk", [(2, 100, 16, 32, 64),
                                              (3, 37, 32, 32, 16),
                                              (1, 500, 16, 16, 256),
                                              (2, 5, 8, 24, 256)])
def test_scan_plain_takes_any_length(bh, s, dk, dv, chunk):
    """S not a multiple of the chunk (the reference asserts one): the tail
    is padded with logf = 0 and i = 0, which is exact."""
    arrs = scan_inputs(bh, s, dk, dv, seed=10)
    r = jref.mlstm_scan_ref(*arrs)
    close(tref.mlstm_chunkwise_ref(*torch_of(*arrs), chunk=chunk), r, 1e-3)
    close(tops.mlstm_scan(*torch_of(*arrs)), r, 1e-3)


@pytest.mark.parametrize("scale", [None, 1.0])
def test_scan_oracle_matches_reference_oracle(scale):
    """The port's step-by-step oracle, dk != dv, scale 1.0 as hymba's SSD
    heads call it."""
    arrs = scan_inputs(3, 40, 16, 64, seed=20)
    r = jref.mlstm_scan_ref(*arrs, scale=scale)
    close(tref.mlstm_scan_ref(*torch_of(*arrs), scale=scale), r, 2e-5)
    close(tref.mlstm_chunkwise_ref(*torch_of(*arrs), scale=scale, chunk=16),
          r, 1e-3)


def test_scan_plain_keeps_its_precision_at_ssd_decays():
    """hymba's SSD gates decay by up to e^-5 a step, so the cumulative log
    decay of a 256-step chunk reaches several hundred; the decay between
    two steps is still exact to float32 (differences of float64 sums),
    where differences of float32 sums miss this bound several times over.
    Against the step-by-step oracle."""
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(rng.standard_normal((4, 512, 16)).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((4, 512, 64)).astype(np.float32))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((4, 512)).astype(np.float32)) * 1.5)
    want = tref.mlstm_scan_ref(q, k, v, -dt, dt, scale=1.0)
    got = tref.mlstm_chunkwise_ref(q, k, v, -dt, dt, scale=1.0, chunk=256)
    assert want.abs().max() > 20
    assert (got - want).abs().max().item() < 5e-5


def test_scan_plain_bfloat16_returns_input_dtype():
    arrs = scan_inputs(2, 64, 16, 16, seed=30)
    t = torch_of(*arrs)
    o = tops.mlstm_scan(t[0].bfloat16(), t[1].bfloat16(), t[2].bfloat16(),
                        t[3], t[4])
    assert o.dtype == torch.bfloat16
    r = np.asarray(jref.mlstm_scan_ref(*arrs))
    assert np.max(np.abs(o.float().numpy() - r)) < 3e-2 * max(1.0, np.abs(r).max())


def test_scan_wrapper_refuses_cpu_tensors():
    t = torch_of(*scan_inputs(1, 8, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kscan.mlstm_scan(*t)
    with pytest.raises(ValueError, match="no path"):
        tops.mlstm_scan(*(x.to("meta") for x in t))


# ----------------------------------------------------------------- blocks
def _xlstm_cfgs(n_layers=6, slstm_every=3):
    """xlstm reduced with sLSTM blocks in its plan (the stock reduced config
    has 2 layers, all mLSTM)."""
    out = []
    for cfg in (get_arch("xlstm-350m").reduced(),
                tget_arch("xlstm-350m").reduced()):
        out.append(dataclasses.replace(
            cfg, n_layers=n_layers,
            ssm=dataclasses.replace(cfg.ssm, slstm_every=slstm_every)))
    return out


def _block_params(init, cfg, seed):
    jp = init(jax.random.PRNGKey(seed), cfg)
    for name, leaf in list(jp.items()):
        if "b" in leaf:          # reference inits biases to zero: make them count
            jp[name] = {**leaf, "b": jnp.asarray(rand(leaf["b"].shape, 50 + seed, 0.5))}
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("s", [16, 37])
def test_mlstm_block_forward_and_decode_match_reference(s):
    cfg, tcfg = _xlstm_cfgs()
    jp, tp = _block_params(JS.mlstm_init, cfg, 0)
    x = rand((2, s, cfg.d_model), 1)
    jy, jst = JS.mlstm_forward(cfg, jp, x, backend="naive", return_state=True)
    ty, tst = TS.mlstm_forward(tcfg, tp, torch.from_numpy(x), return_state=True)
    close(ty, jy, 2e-5)
    cache_close(tst, jst, 2e-5)
    before = {n: t.clone() for n, t in tst.items()}
    for step in range(3):
        xt = rand((2, 1, cfg.d_model), 2 + step)
        jy, jst = JS.mlstm_decode(cfg, jp, xt, jst)
        ty, new = TS.mlstm_decode(tcfg, tp, torch.from_numpy(xt), tst)
        close(ty, jy, 2e-5)
        cache_close(new, jst, 2e-5)
        if step == 0:
            for n in before:             # out of place: the input is kept
                assert torch.equal(tst[n], before[n])
        tst = new


@pytest.mark.parametrize("s", [16, 37, 1000])
def test_slstm_block_forward_and_decode_match_reference(s):
    """The doubling scan against the reference's associative scan, up to a
    thousand steps (where a cumulative product of the forget gates would
    underflow)."""
    cfg, tcfg = _xlstm_cfgs()
    jp, tp = _block_params(JS.slstm_init, cfg, 3)
    x = rand((2, s, cfg.d_model), 4)
    jy, jst = JS.slstm_forward(cfg, jp, x, return_state=True)
    ty, tst = TS.slstm_forward(tcfg, tp, torch.from_numpy(x), return_state=True)
    close(ty, jy, 2e-5)
    cache_close(tst, jst, 2e-5)
    for step in range(3):
        xt = rand((2, 1, cfg.d_model), 5 + step)
        jy, jst = JS.slstm_decode(cfg, jp, xt, jst)
        ty, tst = TS.slstm_decode(tcfg, tp, torch.from_numpy(xt), tst)
        close(ty, jy, 2e-5)
        cache_close(tst, jst, 2e-5)


def test_slstm_scan_does_not_underflow():
    """Forget gates near 0.12 over 1024 steps: their product is 0 in
    float32, the scan's state stays finite and equals a plain loop."""
    f = torch.full((1, 1024, 3), 0.12)
    u = torch.from_numpy(rand((1, 1024, 3), 6))
    w = torch.ones((1, 1024, 3))
    c, n = TS._linear_scan(f, u, w)
    assert torch.prod(f[0, :, 0]).item() == 0.0
    cl, nl = torch.zeros(3), torch.zeros(3)
    for t in range(1024):
        cl, nl = f[0, t] * cl + u[0, t], f[0, t] * nl + w[0, t]
    assert torch.isfinite(c).all()
    assert (c[0, -1] - cl).abs().max() < 1e-5 and (n[0, -1] - nl).abs().max() < 1e-5


# ------------------------------------------------------------------ model
@functools.lru_cache(maxsize=None)
def _jax_params():
    cfg, _ = _xlstm_cfgs()
    return jax.jit(JModel(cfg).init_params)(jax.random.PRNGKey(0))


def _models():
    cfg, tcfg = _xlstm_cfgs()
    jp = _jax_params()
    tm = TModel(tcfg, device="cpu")
    tp = tm.adopt(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    return cfg, JModel(cfg), jp, tm, tp


def test_xlstm_plan_and_init_layout():
    """Groups of mLSTM blocks and one sLSTM block; single segments are not
    stacked, in parameters or in caches."""
    _, tcfg = _xlstm_cfgs()
    tm = TModel(tcfg, device="cpu")
    assert [(s.kind, s.n, s.mixer, s.ffn) for s in tm.plan] == [
        ("scan", 2, "mlstm", "none"), ("single", 1, "slstm", "none")] * 2
    tp = tm.init_params(seed=4)
    jp = _jax_params()
    assert jax.tree.structure(jp) == jax.tree.structure(
        jax.tree.map(lambda t: 0, tp))
    for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert tuple(t.shape) == j.shape
    caches = tm.init_cache(3, 16)
    assert caches[0]["c"].shape == (2, 3, 4, 32, 32)
    assert caches[1]["c"].shape == (3, tcfg.d_model)
    full = TModel(tget_arch("xlstm-350m"), device="cpu")
    assert [(s.kind, s.n, s.mixer) for s in full.plan] == [
        ("scan", 5, "mlstm"), ("single", 1, "slstm")] * 4
    meta = full.init_cache(8, 1024, device="meta")
    assert meta[0]["c"].shape == (5, 8, 4, 512, 512)


def test_xlstm_model_prefill_and_decode_match_reference():
    cfg, jm, jp, tm, tp = _models()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 11)) \
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
        cache_close(tc, jc, 1e-4)
        pos += 1


def test_xlstm_prefill_batch_runs_pads_through_state_as_in_reference():
    """Batched admission right-pads prompts, and the pad tokens run through
    each short row's recurrent state, as in the reference: the states equal
    the reference's and differ from the row's unbatched prefill."""
    cfg, jm, jp, tm, tp = _models()
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
    _, alone = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:1, :3])}, 16)
    assert (alone[0]["c"][:, 0] - tc[0]["c"][:, 0]).abs().max() > 1e-3
    _, full = tm.prefill(tp, {"tokens": torch.from_numpy(toks[1:2])}, 16)
    assert (full[0]["c"][:, 0] - tc[0]["c"][:, 1]).abs().max() < 1e-5


@pytest.mark.timeout(120)
def test_xlstm_engine_matches_direct_decode():
    """A prompt of one whole length bucket (16 tokens) enters no pad token
    into its state: the engine's tokens equal a direct loop's."""
    _, _, _, model, params = _models()
    prompt = np.arange(3, 19, dtype=np.int32)
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
            engine.submit(Request(prompt=prompt[:16], tier="background",
                                  max_new_tokens=5))]
    for r in reqs:
        assert r.done_event.wait(timeout=60)
    engine.stop()
    kernel.stop()
    assert all(r.ok for r in reqs)
    assert reqs[0].tokens == direct
    assert reqs[1].tokens == direct      # bulk prefill: batch 1, no padding
