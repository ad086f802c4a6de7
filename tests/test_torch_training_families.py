"""Training of every registered family against the reference package,
float32 on the CPU: ``train_loss`` and the gradient of every parameter
leaf (MoE with its aux loss, MLA, xLSTM's mLSTM / sLSTM stack, hymba's
hybrid windowed and global layers, the enc-dec over frames, the VLM over
vision embeddings), five AdamW steps of the families with their own
kernels (MoE, xLSTM, hymba), remat, the MoE layer's gradient path (the
down product under autograd, the deterministic dispatch gather) and the
training driver for each family.

Weights come from the reference's ``init_params`` through numpy; inputs
from ``SyntheticTokens`` and numpy with a fixed seed.  The reference runs
its ``xla`` backend.  Tolerances: loss 2e-5; each leaf's max error 2e-5 x
max(1, max |reference leaf|) -- relative to the leaf's scale, since the
xLSTM's tied embedding gradient reaches 15 while others stay far below 1;
five train steps 1e-4 (sums in other orders, carried by Adam's normalised
steps)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.data.pipeline import SyntheticTokens
from repro.models.transformer import Model as JModel
from repro.training import optimizer as JO
from repro.training import trainer as JT
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs.base import all_archs
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import Model as TModel
from repro_torch.models.weights import params_from_numpy, tree_leaves
from repro_torch.training import optimizer as TO
from repro_torch.training import trainer as TT

ARCHS = all_archs()
OWN_KERNELS = ["qwen2-moe-a2.7b", "xlstm-350m", "hymba-1.5b"]


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def leaves_close(t, j, tol):
    """Each leaf's max error within ``tol`` x max(1, max |reference|);
    returns the worst ratio of error to that scale."""
    tl, jl = tree_leaves(t), jax.tree.leaves(j)
    assert len(tl) == len(jl)
    worst = 0.0
    for a, b in zip(tl, jl):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (a.shape, b.shape)
        if a.size:
            err = float(np.max(np.abs(a - b)))
            worst = max(worst, err / max(1.0, float(np.max(np.abs(b)))))
    assert worst < tol, worst
    return worst


def _models(arch, **cut):
    cfg = dataclasses.replace(get_arch(arch).reduced(), **cut)
    tcfg = dataclasses.replace(tget_arch(arch).reduced(), **cut)
    jm = JModel(cfg, backend="xla")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = TModel(tcfg, device="cpu")
    tp = tm.adopt(params_from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu"))
    return jm, jp, tm, tp


def _batch(cfg, step, b=2, s=16, seed=0):
    """Tokens and labels, and the family's stub inputs from numpy."""
    batch = SyntheticTokens(cfg.vocab_size, seed=seed).batch(step, 0, b, s)
    rng = np.random.default_rng(100 + step)
    if cfg.encoder_layers:
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    if cfg.vision_tokens:
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch):
    jm, jp, tm, tp = _models(arch)
    batch = _batch(jm.cfg, 0)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jm.train_loss(p, batch), has_aux=True)(jp)
    tl, tg = TT.value_and_grad(tm, tp, _torch_batch(batch))
    assert abs(float(tl) - float(jl)) < 2e-5
    _, taux = tm.train_loss(tp, _torch_batch(batch))
    assert float(taux["aux"]) == pytest.approx(float(jaux["aux"]), abs=2e-5)
    if tm.cfg.moe is not None:
        assert float(taux["aux"]) > 0
    leaves_close(tg, jg, 2e-5)


@pytest.mark.parametrize("arch", OWN_KERNELS)
def test_train_steps_match_reference(arch):
    jm, jp, tm, tp = _models(arch)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    jcfg = JT.TrainConfig(opt=JO.OptimizerConfig(**kw))
    tcfg = TT.TrainConfig(opt=TO.OptimizerConfig(**kw))
    js = {"params": jp, "opt": JO.init_state(jcfg.opt, jp)}
    ts = {"params": tp, "opt": TO.init_state(tcfg.opt, tp)}
    jstep = jax.jit(JT.make_train_step(jm, jcfg))
    tstep = TT.make_train_step(tm, tcfg)
    for step in range(5):
        batch = _batch(jm.cfg, step, b=4)
        js, jmet = jstep(js, batch)
        ts, tmet = tstep(ts, _torch_batch(batch))
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) < 1e-4, step
    leaves_close(ts["params"], js["params"], 1e-4)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b",
                                  "xlstm-350m", "hymba-1.5b"])
def test_train_loss_with_remat_equals_without(arch):
    """Each layer recomputed in the backward pass gives the same loss and
    gradients: the recomputed routing, scan and window are the forward's."""
    _, _, tm, tp = _models(arch)
    batch = _torch_batch(_batch(tm.cfg, 1))
    rm = TModel(dataclasses.replace(tm.cfg, remat=True), device="cpu")
    l0, g0 = TT.value_and_grad(tm, tp, batch)
    l1, g1 = TT.value_and_grad(rm, tp, batch)
    assert float(l0) == float(l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.allclose(a, b, rtol=0, atol=1e-7)


def _moe_layer(seed=3, scale=50.0):
    base = tget_arch("qwen2-moe-a2.7b").reduced()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, n_routed=60, padded_routed=64, top_k=4))
    p = tmoe.moe_init(torch.Generator().manual_seed(seed), cfg)
    p["router"]["w"] = p["router"]["w"] * scale     # experts fill and drop
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32))
    return cfg, p, x


def test_moe_layer_records_a_gradient_through_every_weight():
    """The expert down product writes into its rows with ``out=`` only
    without a gradient: under autograd the layer differentiates (``bmm``
    with ``out=`` refuses to) and every weight, the router's included,
    gets a finite gradient that is not all zero; the output equals the
    no-gradient path's bit for bit."""
    cfg, p, x = _moe_layer()
    leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
    y, aux = tmoe.moe_forward(cfg, p, x, capacity_factor=0.5)
    grads = torch.autograd.grad((y.square().sum() + aux), leaves)
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)
    with torch.no_grad():
        y0, aux0 = tmoe.moe_forward(cfg, p, x, capacity_factor=0.5)
    assert torch.equal(y.detach(), y0) and torch.equal(aux.detach(), aux0)


def test_dispatch_gather_gradient_is_the_gathers_transpose():
    """``DispatchGather``'s gradient (a gather through ``slot``, summed
    over k in order) equals autograd of the plain row gather (an
    ``index_add_``), with dropped pairs and empty slots; the zero row
    takes no gradient."""
    cfg, p, x = _moe_layer()
    xf = x.reshape(-1, cfg.d_model)
    logits = xf @ p["router"]["w"]
    from repro_torch.kernels import ops
    r = ops.moe_route(logits, cfg.moe.top_k, capacity=3,
                      n_valid=cfg.moe.n_routed)
    assert (r.slot == r.slot_tok.numel()).any()          # dropped pairs
    assert (r.slot_tok == xf.shape[0]).any()             # empty slots
    dbuf = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (r.slot_tok.numel(), cfg.d_model)).astype(np.float32))
    xa = xf.clone().requires_grad_(True)
    got, = torch.autograd.grad(
        tmoe.DispatchGather.apply(xa, r.slot_tok, r.slot), xa, dbuf)
    xb = xf.clone().requires_grad_(True)
    xz = torch.cat([xb, xb.new_zeros((1, cfg.d_model))])
    want, = torch.autograd.grad(xz.index_select(0, r.slot_tok.reshape(-1)),
                                xb, dbuf)
    assert torch.allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "llama3.2-1b"])
def test_train_cli_takes_every_arch_on_cpu(arch, capsys):
    """``launch/train.py --arch <arch> --reduced --device cpu``: two steps
    with finite losses, the family's stub frames or vision embeddings
    built by the driver."""
    out = ttrain.run(ttrain.parse_args(
        ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "16", "--log-every", "1"]))
    assert sorted(out["losses"]) == [1, 2]
    assert all(np.isfinite(v) for v in out["losses"].values())
    assert f"arch={arch}" in capsys.readouterr().out


@pytest.mark.timeout(180)
def test_scheduled_moe_crash_and_resume_reproduce_uninterrupted_run(tmp_path):
    """qwen2-moe reduced through ``--scheduled``: a crash after step 4 and
    ``--resume`` give the uninterrupted run's losses exactly, the routing
    and its gradient included."""
    base = ["--arch", "qwen2-moe-a2.7b", "--reduced", "--device", "cpu",
            "--steps", "6", "--batch", "2", "--seq", "16", "--ckpt-every",
            "2", "--log-every", "1"]
    sched, plain = str(tmp_path / "s"), str(tmp_path / "p")
    first = ttrain.run(ttrain.parse_args(
        base + ["--ckpt-dir", sched, "--scheduled", "--fail-at", "4"]))
    second = ttrain.run(ttrain.parse_args(
        base + ["--ckpt-dir", sched, "--scheduled", "--resume"]))
    whole = ttrain.run(ttrain.parse_args(base + ["--ckpt-dir", plain]))
    assert first["failed_at"] == 4 and second["start_step"] == 4
    assert [first["losses"][i] for i in (1, 2, 3, 4)] == [
        whole["losses"][i] for i in (1, 2, 3, 4)]
    assert [second["losses"][i] for i in (5, 6)] == [
        whole["losses"][i] for i in (5, 6)]


def test_all_dense_moe_config_trains_as_the_reference():
    """deepseek-v3 cut to its dense layers (n_layers = first_k_dense): the
    plan keeps an empty MoE segment, as the reference's does; its leaves
    get zero gradients, the rest match the reference."""
    jm, jp, tm, tp = _models("deepseek-v3-671b", n_layers=2, first_k_dense=2)
    batch = _batch(jm.cfg, 0)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jm.train_loss(p, batch), has_aux=True)(jp)
    tl, tg = TT.value_and_grad(tm, tp, _torch_batch(batch))
    assert abs(float(tl) - float(jl)) < 2e-5
    assert any(t.numel() == 0 for t in tree_leaves(tg))
    leaves_close(tg, jg, 2e-5)


def test_value_and_grad_raises_for_a_disconnected_weight():
    """Only empty leaves get zeros: a non-empty leaf that the loss does not
    read is a fault and raises, rather than training on with a zero
    gradient."""
    _, _, tm, tp = _models("llama3.2-1b")
    batch = _torch_batch(_batch(tm.cfg, 0))
    _, g = TT.value_and_grad(tm, {**tp, "unread": torch.zeros(0)}, batch)
    assert g["unread"].shape == (0,)
    with pytest.raises(RuntimeError, match="not have been used"):
        TT.value_and_grad(tm, {**tp, "unread": torch.zeros(3)}, batch)
