"""The port's roofline against the reference package's: the analytic model
flops, attention flops, active parameters and memory for every registered
arch x shape x device count (relative 1e-12), the parameter count at full
size (the port's tree on the ``meta`` device against ``jax.eval_shape``),
the terms under the H100's constants, ``analyze`` on a reduced llama
prefill and train step, and the report's rows (float32, CPU).  The
collectives a gloo group issues are held in test_torch_distributed.py."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES
from repro.configs import get_arch as jget_arch
from repro.models.transformer import Model as JModel
from repro.roofline import analysis as JRA
from repro.roofline import report as JREP
from repro_torch.configs import all_archs, get_arch
from repro_torch.kernels import work
from repro_torch.models.transformer import Model
from repro_torch.models.weights import tree_leaves
from repro_torch.roofline import analysis as RA
from repro_torch.roofline import report as REP

ARCHS = all_archs()
DEVICES = (1, 8, 256, 512)


@functools.lru_cache(maxsize=None)
def meta_params(arch: str):
    """The port's parameter tree at full size on the ``meta`` device."""
    return Model(get_arch(arch), device="meta").init_params()


@functools.lru_cache(maxsize=None)
def port_params(arch: str) -> int:
    return RA.count_params(meta_params(arch))


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_counts_equal_reference(arch, shape):
    cfg, jcfg, sh = get_arch(arch), jget_arch(arch), SHAPES[shape]
    n = port_params(arch)
    assert RA.active_params(cfg, n) == JRA.active_params(jcfg, n)
    for dev in DEVICES:
        for got, want in (
                (RA.model_flops(cfg, sh, n, dev),
                 JRA.model_flops(jcfg, sh, n, dev)),
                (RA.attn_model_flops(cfg, sh, dev),
                 JRA.attn_model_flops(jcfg, sh, dev)),
                (RA.analytic_memory_bytes(cfg, sh, 3.5e9, 1.25e9, dev),
                 JRA.analytic_memory_bytes(jcfg, sh, 3.5e9, 1.25e9, dev))):
            assert rel(got, want) <= 1e-12, (dev, got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_at_full_size_equals_reference(arch):
    shapes = jax.eval_shape(
        lambda: JModel(jget_arch(arch)).init_params(jax.random.PRNGKey(0)))
    tree = meta_params(arch)
    assert all(x.device.type == "meta" for x in tree_leaves(tree))
    assert RA.count_params(tree) == JRA.count_params(shapes)
    assert [tuple(x.shape) for x in tree_leaves(tree)] == [
        tuple(x.shape) for x in jax.tree.leaves(shapes)]


def test_roofline_terms_under_h100_constants():
    assert RA.PEAK_FLOPS[torch.bfloat16] == 989e12
    assert RA.PEAK_FLOPS[torch.float32] == 67e12
    assert (RA.HBM_BW, RA.NVLINK_BW) == (3.35e12, 450e9)
    r = RA.Roofline(flops=1e12, hbm_bytes=1e9, coll_bytes=1e12,
                    model_flops=5e11)
    assert r.bottleneck == "collective"
    assert r.t_collective == pytest.approx(1e12 / 450e9)
    assert r.t_compute == pytest.approx(1e12 / 989e12)
    assert r.t_memory == pytest.approx(1e9 / 3.35e12)
    assert r.mfu_bound == pytest.approx((5e11 / 989e12) / r.t_collective)
    assert 0 < r.mfu_bound < 1
    f = RA.Roofline(flops=67e12, hbm_bytes=1e9, coll_bytes=0,
                    model_flops=67e12, dtype=torch.float32)
    assert f.bottleneck == "compute" and f.t_compute == pytest.approx(1.0)
    assert f.mfu_bound == pytest.approx(1.0)
    d = r.to_dict()
    jd = JRA.Roofline(flops=1e12, hbm_bytes=1e9, coll_bytes=1e12,
                      model_flops=5e11).to_dict()
    assert set(jd) <= set(d)


def test_analyze_counts_matmuls_and_the_flash_kernel_on_a_prefill():
    cfg = get_arch("llama3.2-1b").reduced()
    model = Model(cfg, device="cpu")
    params = model.init_params(seed=0)
    b, s = 2, 16
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)), dtype=torch.int32)
    r = RA.analyze(model.prefill, params, {"tokens": toks}, 32,
                   dtype=torch.float32)
    layer_w = sum(x.numel() for x in tree_leaves(params["segments"])
                  if x.dim() == 3)               # stacked (L, d_in, d_out)
    head = 2 * b * cfg.vocab_size * cfg.d_model  # last-position logits
    k1 = r.kernels["flash_attention"]
    assert k1["calls"] == cfg.n_layers
    assert r.flops - k1["ops"] == 2 * b * s * layer_w + head
    q = torch.empty(b, s, cfg.n_heads, cfg.hd)
    kv = torch.empty(b, s, cfg.n_kv_heads, cfg.hd)
    one = work.flash(q, kv, kv, causal=True, window=0)
    pairs = s * (s + 1) // 2
    assert one.ops == 2 * b * cfg.n_heads * 2 * cfg.hd * pairs
    assert k1["ops"] == cfg.n_layers * one.ops
    assert k1["bytes"] == cfg.n_layers * one.bytes
    assert r.hbm_bytes > k1["bytes"] and r.coll_bytes == 0
    assert r.bottleneck in ("compute", "memory")


def test_a_float32_product_in_a_bf16_step_runs_at_the_float32_peak():
    a = torch.randn(64, 128, dtype=torch.bfloat16)
    w = torch.randn(128, 256, dtype=torch.bfloat16)

    def step():
        h = a @ w                                # bf16: 2 * 64 * 128 * 256
        return h.float() @ w.float().T           # float32: 2 * 64 * 256 * 128
    r = RA.analyze(step)
    n = 2 * 64 * 128 * 256
    assert r.flops_by_type == {torch.bfloat16: n, torch.float32: n}
    assert r.flops == 2 * n
    assert r.t_compute == pytest.approx(n / 989e12 + n / 67e12, rel=1e-12)
    assert r.to_dict()["flops_by_type"] == {"bfloat16": n, "float32": n}
    # without a split, all of ``flops`` is priced at the step's type
    assert RA.Roofline(flops=2 * n, hbm_bytes=0, coll_bytes=0).t_compute \
        == pytest.approx(2 * n / 989e12, rel=1e-12)


def test_analyze_prices_a_tied_unembedding_in_float32():
    """llama's tied unembedding is a float32 product in a bf16 prefill;
    the layers' products and K1 run in bf16."""
    cfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                              dtype="bfloat16")
    model = Model(cfg, device="cpu")
    params = model.init_params(seed=0)
    b, s = 2, 16
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, s)), dtype=torch.int32)
    r = RA.analyze(model.prefill, params, {"tokens": toks}, 32)
    layer_w = sum(x.numel() for x in tree_leaves(params["segments"])
                  if x.dim() == 3)
    head = 2 * b * cfg.vocab_size * cfg.d_model
    k1 = r.kernels["flash_attention"]["ops"]
    assert cfg.tie_embeddings
    assert r.flops_by_type == {torch.bfloat16: 2 * b * s * layer_w + k1,
                               torch.float32: head}
    assert r.t_compute == pytest.approx(
        (2 * b * s * layer_w + k1) / 989e12 + head / 67e12, rel=1e-12)


def test_analyze_counts_the_backward_and_changes_no_result():
    cfg = get_arch("llama3.2-1b").reduced()
    model = Model(cfg, device="cpu")
    params = model.init_params(seed=0)
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)), dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}

    def step():
        loss, _ = model.train_loss(params, batch)
        return loss, torch.autograd.grad(loss, leaves)
    want_loss, want = step()
    # The hook and the byte counter change no bit.
    with work.recording(), RA._Counter():
        got_loss, got = step()
    assert torch.equal(got_loss, want_loss)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # FlopCounterMode itself moves the order of some gradient sums.
    box = {}
    r = RA.analyze(lambda: box.update(out=step()), dtype=torch.float32)
    got_loss, got = box["out"]
    assert torch.equal(got_loss, want_loss)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-6 * w.abs().max()
    fwd, bwd = r.kernels["flash_attention"], r.kernels["flash_attention_bwd"]
    assert fwd["calls"] == bwd["calls"] == cfg.n_layers
    q = torch.empty(2, 16, cfg.n_heads, cfg.hd)
    kv = torch.empty(2, 16, cfg.n_kv_heads, cfg.hd)
    assert bwd["ops"] == cfg.n_layers * work.flash_bwd(q, kv, kv).ops
    assert work.flash_bwd(q, kv, kv).ops == 2.5 * work.flash(q, kv, kv).ops


def test_counting_is_off_outside_analyze():
    from repro_torch.kernels import ops
    x = torch.randn(4, 8, 16)
    with work.recording() as calls:
        ops.flash_attention(x, x, x)
        ops.moe_topk(torch.randn(5, 8), 2)
    assert [w.name for w in calls] == ["flash_attention", "moe_topk"]
    ops.flash_attention(x, x, x)
    assert len(calls) == 2


def test_bound_takes_the_larger_term():
    w = work.Work("k", ops=67e12, bytes=3.35e9, dtype=torch.float32)
    assert RA.bound_ms(w) == (pytest.approx(1000.0), "operations")
    w = work.Work("k", ops=1.0, bytes=3.35e9, dtype=torch.bfloat16)
    assert RA.bound_ms(w) == (pytest.approx(1.0), "bytes")


def _results() -> dict:
    """A synthetic dry-run results dict in the reference's layout."""
    out = {}
    for i, (arch, shape) in enumerate([
            ("llama3.2-1b", "train_4k"), ("qwen2-moe-a2.7b", "prefill_32k"),
            ("deepseek-v3-671b", "decode_32k"), ("hymba-1.5b", "train_4k")]):
        out[f"{arch}|{shape}"] = {
            "status": "ok", "mesh": "16x16", "arch": arch, "shape": shape,
            "kind": SHAPES[shape].kind, "n_devices": 256,
            "n_params": port_params(arch),
            "roofline": {"flops": 1.5e13 * (i + 1), "hbm_bytes": 2e10 * (i + 1),
                         "coll_bytes": 3e9 * (i + 1),
                         "coll_detail": {"all-gather": 1e9},
                         "coll_counts": {"all-gather": 2}},
            "memory": {"argument_bytes": 4e9, "output_bytes": 1e9,
                       "peak_bytes": 6e9}}
    out["x|y"] = {"status": "error", "mesh": "16x16", "arch": "x",
                  "shape": "y", "error": "boom"}
    return out


def test_report_rows_equal_reference_in_the_ratio_of_the_constants():
    res = _results()
    got, want = REP.roofline_rows(res), JREP.roofline_rows(res)
    assert len(got) == len(want) == 4
    ratios = {"t_compute_ms": JRA.PEAK_FLOPS / RA.PEAK_FLOPS[torch.bfloat16],
              "t_memory_ms": JRA.HBM_BW / RA.HBM_BW,
              "t_memory_hlo_ms": JRA.HBM_BW / RA.HBM_BW,
              "t_collective_ms": JRA.ICI_BW / RA.NVLINK_BW}
    for g, w in zip(got, want):
        for k in ("arch", "shape", "kind", "coll_detail", "coll_counts"):
            assert g[k] == w[k]
        for k in ("model_flops", "flops_adj", "useful", "peak_gb", "arg_gb"):
            assert rel(g[k], w[k]) <= 1e-12, k
        for k, ratio in ratios.items():
            assert rel(g[k], w[k] * ratio) <= 1e-12, k
    assert [r["arch"] for r in got if r["arch"].endswith("†")] == [
        "deepseek-v3-671b †"]                      # the scanned cell
    assert REP.dryrun_summary(res) == JREP.dryrun_summary(res)
    assert REP.markdown_table(got).count("\n") == len(got) + 2


@pytest.mark.parametrize("arch,kernels", [
    ("qwen2-moe-a2.7b", {"flash_attention", "flash_attention_bwd",
                         "moe_topk", "moe_route_bwd"}),
    ("xlstm-350m", {"mlstm_scan", "mlstm_scan_bwd"}),
    ("hymba-1.5b", {"flash_attention", "flash_attention_bwd", "mlstm_scan",
                    "mlstm_scan_bwd"}),
    ("deepseek-v3-671b", {"flash_attention", "flash_attention_bwd",
                          "moe_topk", "moe_route_bwd"})])
def test_counting_changes_no_bit_of_a_family_gradient(arch, kernels):
    """Every family's train loss and gradient (plain versions on the CPU)
    are bit-identical under the work hook and the byte counter, and each
    kernel of the path, forward and backward, reports its work."""
    cfg = get_arch(arch).reduced()
    model = Model(cfg, device="cpu")
    params = model.init_params(seed=0)
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)
              if x.is_floating_point()]
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)), dtype=torch.int32)

    def step():
        loss, _ = model.train_loss(params, {"tokens": toks, "labels": toks})
        return loss, torch.autograd.grad(loss, leaves, allow_unused=True)
    want_loss, want = step()
    with work.recording() as calls, RA._Counter():
        got_loss, got = step()
    assert torch.equal(got_loss, want_loss)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)
    assert {w.name for w in calls} == kernels
