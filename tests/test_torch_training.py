"""The port's training path against the reference package, float32 on the
CPU: the AdamW step and its schedule, int8 gradient compression, the
model's training loss and gradients, the train step's trajectory with and
without gradient accumulation, checkpoints swapped between the packages,
and the scheduled training driver's crash and resume.  Weights come from
the reference's ``init_params`` through numpy (``params_from_numpy``);
inputs from numpy with a fixed seed.  The reference runs its ``xla``
backend, its training path.  Tolerances: optimizer, schedule and
compression 1e-6; loss and gradients 2e-5; five train steps 1e-4 (the
two sum in different orders, and Adam's normalised steps carry that)."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.data.pipeline import SyntheticTokens
from repro.models.transformer import Model as JModel
from repro.training import checkpoint as JC
from repro.training import grad_compress as JG
from repro.training import optimizer as JO
from repro.training import trainer as JT
from repro_torch.configs import get_arch as tget_arch
from repro_torch.launch import train as ttrain
from repro_torch.models.transformer import Model as TModel
from repro_torch.models.weights import (params_from_numpy, tree_leaves,
                                        tree_unflatten)
from repro_torch.training import checkpoint as TC
from repro_torch.training import grad_compress as TG
from repro_torch.training import optimizer as TO
from repro_torch.training import trainer as TT


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def trees_close(t, j, tol):
    tl, jl = tree_leaves(t), jax.tree.leaves(j)
    assert len(tl) == len(jl)
    worst = 0.0
    for a, b in zip(tl, jl):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (a.shape, b.shape)
        if a.size:
            worst = max(worst, float(np.max(np.abs(a - b))))
    assert worst < tol, worst
    return worst


def _rand_tree(seed, dtype=np.float32, scale=1.0):
    """A parameter-like tree: a matrix, a scanned segment's stacked norm
    scales (2, 8), a final norm (8,), a list of stacked matrices."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal(shape) * scale).astype(dtype)
    return {"w": r(4, 8), "norm": {"g": r(2, 8)}, "final": {"g": r(8)},
            "segments": [{"w": r(2, 8, 4)}]}


# ----------------------------------------------------------- optimizer
def test_lr_schedule_matches_reference():
    cfg = TO.OptimizerConfig(lr=3e-3, warmup_steps=7, total_steps=40)
    jcfg = JO.OptimizerConfig(lr=3e-3, warmup_steps=7, total_steps=40)
    for step in range(0, 45, 3):
        got = float(TO.lr_at(cfg, torch.tensor(step, dtype=torch.int32)))
        want = float(JO.lr_at(jcfg, jnp.asarray(step, jnp.int32)))
        assert abs(got - want) < 1e-9 * max(1.0, abs(want)) + 1e-12, step


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])     # 10: the clip acts
def test_apply_updates_matches_reference(state_dtype, grad_scale):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, state_dtype=state_dtype)
    cfg, jcfg = TO.OptimizerConfig(**kw), JO.OptimizerConfig(**kw)
    params = _rand_tree(0)
    tp = params_from_numpy(params, device="cpu")
    jp = jax.tree.map(jnp.asarray, params)
    ts, js = TO.init_state(cfg, tp), JO.init_state(jcfg, jp)
    for i in range(3):
        grads = _rand_tree(10 + i, scale=grad_scale)
        tp, ts, tm = TO.apply_updates(cfg, tp, params_from_numpy(
            grads, device="cpu"), ts)
        jp, js, jm = JO.apply_updates(jcfg, jp, jax.tree.map(jnp.asarray,
                                                             grads), js)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                       rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert int(ts["step"]) == int(js["step"]) and ts["step"].dtype == torch.int32
    trees_close(tp, jp, 1e-6)
    trees_close(ts["m"], js["m"], 1e-6)
    trees_close(ts["v"], js["v"], 1e-6)
    want_dt = torch.bfloat16 if state_dtype else torch.float32
    assert all(t.dtype == want_dt for t in tree_leaves(ts["m"]))


def test_weight_decay_reaches_stacked_norm_scales_as_in_reference():
    """With zero gradients only the decay moves a parameter: the stacked
    (n_layers, d) norm scales of a scanned segment are 2-D and decay, the
    final norm's (d,) does not -- in both packages."""
    cfg = TO.OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    params = _rand_tree(0)
    tp = params_from_numpy(params, device="cpu")
    zeros = {k: v for k, v in params_from_numpy(
        jax.tree.map(np.zeros_like, params), device="cpu").items()}
    new, _, _ = TO.apply_updates(cfg, tp, zeros, TO.init_state(cfg, tp))
    assert torch.equal(new["final"]["g"], tp["final"]["g"])
    assert not torch.equal(new["norm"]["g"], tp["norm"]["g"])
    jnew, _, _ = JO.apply_updates(
        JO.OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=10),
        jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.zeros_like, params),
        JO.init_state(JO.OptimizerConfig(), jax.tree.map(jnp.asarray, params)))
    trees_close(new, jnew, 1e-6)


def test_apply_updates_is_out_of_place():
    """A snapshot of the state before a step stays that state."""
    cfg = TO.OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    tp = params_from_numpy(_rand_tree(0), device="cpu")
    state = {"params": tp, "opt": TO.init_state(cfg, tp)}
    before = [t.clone() for t in tree_leaves(state)]
    TO.apply_updates(cfg, tp, params_from_numpy(_rand_tree(1), device="cpu"),
                     state["opt"])
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(state)))


def test_compress_decompress_matches_reference():
    grads = _rand_tree(3, scale=0.1)
    # exact halves: max |g| = 127 gives scale 1, so g / scale hits .5 ties,
    # which both packages round to even
    grads["final"]["g"] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                                    3.25], np.float32)
    tg = params_from_numpy(grads, device="cpu")
    te, je = TG.init_error_state(tg), JG.init_error_state(
        jax.tree.map(jnp.asarray, grads))
    for i in range(2):                       # the second step feeds back
        g = _rand_tree(20 + i, scale=0.1) if i else grads
        tout, te = TG.compress_decompress(params_from_numpy(g, device="cpu"), te)
        jout, je = JG.compress_decompress(jax.tree.map(jnp.asarray, g), je)
        trees_close(tout, jout, 1e-6)
        trees_close(te, je, 1e-6)
        if i == 0:
            assert tout["final"]["g"][:8].tolist() == [127, 0, 2, 2, 0, -2, -2, 3]


# ------------------------------------------------------- model and step
def _models(arch="llama3.2-1b", **cut):
    cfg = dataclasses.replace(get_arch(arch).reduced(), **cut)
    tcfg = dataclasses.replace(tget_arch(arch).reduced(), **cut)
    jm = JModel(cfg, backend="xla")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = TModel(tcfg, device="cpu")
    tp = tm.adopt(params_from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu"))
    return jm, jp, tm, tp


def _batch(vocab, step, b=2, s=16):
    return SyntheticTokens(vocab, seed=0).batch(step, 0, b, s)


def test_train_loss_and_grads_match_reference():
    jm, jp, tm, tp = _models()
    batch = _batch(jm.cfg.vocab_size, 0)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jm.train_loss(p, batch), has_aux=True)(jp)
    tl, tg = TT.value_and_grad(tm, tp, batch)
    assert abs(float(tl) - float(jl)) < 2e-5
    _, taux = tm.train_loss(tp, batch)
    assert float(taux["loss"]) == pytest.approx(float(jaux["loss"]), abs=2e-5)
    assert float(taux["aux"]) == 0.0 == float(jaux["aux"])
    trees_close(tg, jg, 2e-5)


def test_train_loss_with_remat_equals_without():
    """``cfg.remat`` recomputes each layer in the backward pass
    (``torch.utils.checkpoint``); loss and gradients do not change."""
    _, _, tm, tp = _models()
    batch = _batch(tm.cfg.vocab_size, 1)
    rm = TModel(dataclasses.replace(tm.cfg, remat=True), device="cpu")
    l0, g0 = TT.value_and_grad(tm, tp, batch)
    l1, g1 = TT.value_and_grad(rm, tp, batch)
    assert float(l0) == float(l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.allclose(a, b, rtol=0, atol=1e-7)


def test_remat_recomputes_each_layer_only_under_a_gradient(monkeypatch):
    """With ``cfg.remat`` a gradient runs each layer's mixer twice (the
    forward, then its recomputation in the backward pass); a prefill,
    which records no gradient of the weights, runs it once."""
    from repro_torch.models import transformer as TTm
    _, _, tm, tp = _models()
    rm = TModel(dataclasses.replace(tm.cfg, remat=True), device="cpu")
    n_layers = sum(seg.n if seg.kind == "scan" else 1 for seg in rm.plan)
    calls = []
    mixer = TTm._apply_mixer_seq
    monkeypatch.setattr(TTm, "_apply_mixer_seq",
                        lambda *a, **kw: calls.append(1) or mixer(*a, **kw))
    batch = _batch(tm.cfg.vocab_size, 1)
    TT.value_and_grad(tm, tp, batch)
    assert len(calls) == n_layers
    calls.clear()
    TT.value_and_grad(rm, tp, batch)
    assert len(calls) == 2 * n_layers
    calls.clear()
    rm.prefill(tp, {"tokens": batch["tokens"]}, smax=32)
    assert len(calls) == n_layers


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_reference(accum):
    jm, jp, tm, tp = _models()
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    jcfg = JT.TrainConfig(grad_accum=accum, opt=JO.OptimizerConfig(**kw))
    tcfg = TT.TrainConfig(grad_accum=accum, opt=TO.OptimizerConfig(**kw))
    js = {"params": jp, "opt": JO.init_state(jcfg.opt, jp)}
    ts = {"params": tp, "opt": TO.init_state(tcfg.opt, tp)}
    jstep = jax.jit(JT.make_train_step(jm, jcfg))
    tstep = TT.make_train_step(tm, tcfg)
    for step in range(5):
        batch = _batch(jm.cfg.vocab_size, step, b=4)
        js, jmet = jstep(js, batch)
        ts, tmet = tstep(ts, batch)
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) < 1e-4, step
    trees_close(ts["params"], js["params"], 1e-4)
    assert int(ts["opt"]["step"]) == 5


# ------------------------------------------------------------ checkpoints
def _state(dtype):
    """A train state of the reduced llama in ``dtype``, in both packages."""
    _, jp, _, _ = _models(dtype=dtype)
    js = {"params": jp, "opt": JO.init_state(JO.OptimizerConfig(), jp)}
    js["opt"]["m"] = jax.tree.map(lambda p: jnp.full(p.shape, 0.25, jnp.float32),
                                  jp)
    js["opt"]["step"] = jnp.asarray(7, jnp.int32)
    return js


def _torch_like(js):
    """The port's state tree of the same structure, zeroed."""
    host = jax.tree.map(lambda x: np.zeros(x.shape, np.float32), js)
    tree = params_from_numpy(host, device="cpu")
    for tl, jl in zip(tree_leaves(tree), jax.tree.leaves(js)):
        assert tl.shape == jl.shape
    return tree_unflatten(tree, [
        t.to({"bfloat16": torch.bfloat16, "int32": torch.int32}.get(
            str(j.dtype), torch.float32))
        for t, j in zip(tree_leaves(tree), jax.tree.leaves(js))])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_restores_reference_checkpoint(tmp_path, dtype):
    js = _state(dtype)
    JC.CheckpointManager(str(tmp_path)).save(7, js)
    step, got = TC.CheckpointManager(str(tmp_path)).restore_latest(
        _torch_like(js))
    assert step == 7
    for t, j in zip(tree_leaves(got), jax.tree.leaves(js)):
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
        assert np.array_equal(_np(t), _np(j))


def test_reference_restores_port_checkpoint_float32(tmp_path):
    js = _state("float32")
    # the port's state of the same values, saved by the port
    JC.CheckpointManager(str(tmp_path / "ref")).save(3, js)
    tree = TC.CheckpointManager(str(tmp_path / "ref")).restore(
        3, _torch_like(js))
    TC.CheckpointManager(str(tmp_path / "port")).save(3, tree)
    got = JC.CheckpointManager(str(tmp_path / "port")).restore(3, js)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(js)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_writes_the_reference_files(tmp_path, dtype):
    """Every leaf file and the manifest are byte-identical to the
    reference's for the same state: a bf16 leaf as descr ``<V2``, manifest
    dtype ``bfloat16``, the same sha256."""
    js = _state(dtype)
    JC.CheckpointManager(str(tmp_path / "ref")).save(5, js)
    tree = TC.CheckpointManager(str(tmp_path / "ref")).restore(
        5, _torch_like(js))
    TC.CheckpointManager(str(tmp_path / "port")).save(5, tree)
    rd, pd = tmp_path / "ref" / "step_00000005", tmp_path / "port" / "step_00000005"
    assert sorted(os.listdir(rd)) == sorted(os.listdir(pd))
    for name in sorted(os.listdir(rd)):
        assert (rd / name).read_bytes() == (pd / name).read_bytes(), name
    manifest = json.loads((pd / "manifest.json").read_text())
    bf16 = [e["file"] for e in manifest["leaves"] if e["dtype"] == "bfloat16"]
    assert bool(bf16) == (dtype == "bfloat16")
    for name in bf16:
        assert b"'descr': '<V2'" in (pd / name).read_bytes()[:128]


def test_checkpoint_detects_corruption_and_keeps_newest(tmp_path):
    js = _state("float32")
    JC.CheckpointManager(str(tmp_path / "ref")).save(1, js)
    tree = TC.CheckpointManager(str(tmp_path / "ref")).restore(1, _torch_like(js))
    mgr = TC.CheckpointManager(str(tmp_path / "p"), keep_n=2, async_save=True)
    for s in (1, 2, 3):
        mgr.save(s, tree)
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    leaf = tmp_path / "p" / "step_00000003" / "leaf-00000.npy"
    data = bytearray(leaf.read_bytes())
    data[-1] ^= 0xFF
    leaf.write_bytes(bytes(data))
    with pytest.raises(IOError, match="hash mismatch"):
        mgr.restore(3, tree)


# ------------------------------------------------------------- the driver
ARGS = ["--reduced", "--device", "cpu", "--steps", "6", "--batch", "2",
        "--seq", "16", "--log-every", "1"]


@pytest.mark.timeout(180)
def test_scheduled_crash_and_resume_reproduce_uninterrupted_run(tmp_path):
    ck = str(tmp_path / "sched")
    first = ttrain.run(ttrain.parse_args(
        ARGS + ["--ckpt-dir", ck, "--ckpt-every", "2", "--scheduled",
                "--fail-at", "4"]))
    assert first["failed_at"] == 4 and sorted(first["losses"]) == [1, 2, 3, 4]
    second = ttrain.run(ttrain.parse_args(
        ARGS + ["--ckpt-dir", ck, "--ckpt-every", "2", "--scheduled",
                "--resume"]))
    assert second["start_step"] == 4 and second["failed_at"] is None
    plain = str(tmp_path / "plain")
    whole = ttrain.run(ttrain.parse_args(
        ARGS + ["--ckpt-dir", plain, "--ckpt-every", "2"]))
    for s in (5, 6):
        assert second["losses"][s] == whole["losses"][s], s
    for s in (1, 2, 3, 4):
        assert first["losses"][s] == whole["losses"][s], s
    # The scheduled save of step 2 ran after steps 3 and 4: it must hold
    # step 2's state, as the unscheduled save of step 2 does.
    like = whole["state"]
    a = TC.CheckpointManager(ck).restore(2, like)
    b = TC.CheckpointManager(plain).restore(2, like)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                tree_leaves(b)))
    assert not all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                    tree_leaves(like)))
    for x, y in zip(tree_leaves(whole["state"]), tree_leaves(second["state"])):
        assert torch.equal(x, y)


def test_train_cli_defaults_to_the_card_and_full_config():
    args = ttrain.parse_args([])
    assert args.device == "cuda" and args.reduced is False
    with pytest.raises(SystemExit, match="simulated failure at step 1"):
        ttrain.main(ARGS + ["--steps", "2", "--fail-at", "1"])


@pytest.mark.timeout(180)
def test_serve_with_background_train_lane_on_cpu(capsys):
    """The reference's mixed workload: every request finishes while the
    background lane trains the served architecture from its own weights."""
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--arch", "llama3.2-1b", "--requests", "3",
                "--max-new-tokens", "4", "--background-train"])
    out = capsys.readouterr().out
    assert "completed 3/3 requests" in out
    steps = int(out.split("background train steps: ")[1].split()[0])
    assert steps >= 1
