"""The port's dry-run against the reference package's: the example inputs
of every registered arch x shape at full size (shapes and dtypes, the
caches against ``jax.eval_shape``), ``Model.cache_pspecs`` on the 16x16
and 2x16x16 production meshes (mesh-like objects, as
test_torch_distributed.py uses), the training step's accumulation for
every shape x mesh x unroll; the fake trace of rank 0 (``FakeTensorMode``
over DTensor on a fake process group, the plain versions on the CPU) for
every family at reduced size on a fake 4 x 2 mesh, in the reference's
record layout, which ``roofline.report`` reads; on a one-rank mesh the
traced flops equal to ``analyze`` of a real CPU run of the same step; a
full-width decode cell traced with the process's memory far below the
model's bytes; each sharding hook on a 2-rank gloo group against the plain
run (2e-5); each kernel's shape-only outputs against its plain version's;
``hillclimb --only`` and ``fill_experiments`` in a directory of their own,
and ``perf_table`` equal to the reference's under the reference's
constants."""
import json
import os
import resource
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

jax.devices()          # the reference's dryrun module sets XLA_FLAGS on import
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs.base import SHAPES  # noqa: E402
from repro.launch import dryrun as JD  # noqa: E402
from repro.launch import specs as JSPEC  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro.roofline import analysis as JRA  # noqa: E402
from repro.roofline import fill_experiments as JFILL  # noqa: E402

if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

from repro_torch.configs import all_archs, get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels import decode_attention as KD  # noqa: E402
from repro_torch.kernels import flash_attention as KF  # noqa: E402
from repro_torch.kernels import mlstm_scan as KS  # noqa: E402
from repro_torch.kernels import moe_topk as KM  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import specs as SPEC  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.roofline import analysis as RA  # noqa: E402
from repro_torch.roofline import fill_experiments as FILL  # noqa: E402
from repro_torch.roofline import report as REP  # noqa: E402
from repro_torch.training import trainer as T  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
ARCHS = all_archs()


class FakeMesh:
    """The two fields the rules read, as the reference's mesh has them."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


MESHES = {"16x16": FakeMesh((16, 16), ("data", "model")),
          "2x16x16": FakeMesh((2, 16, 16), ("pod", "data", "model"))}


def port_leaves(tree):
    """Leaves in the reference's flattening order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in port_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in port_leaves(v)]
    return [tree]


def shapes_dtypes(leaves):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in leaves]


# ------------------------------------------------- specs, cache specs, accum
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch, shape):
    cfg, jcfg, sh = get_arch(arch), jget_arch(arch), SHAPES[shape]
    kind, got = SPEC.input_specs(cfg, sh, Model(cfg, device="cpu"))
    jkind, want = JSPEC.input_specs(jcfg, sh, JModel(jcfg))
    assert kind == jkind
    assert shapes_dtypes(port_leaves(got)) == [
        (tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(want)]
    from torch._subclasses.fake_tensor import FakeTensor
    assert all(isinstance(x, FakeTensor) for x in port_leaves(got))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_equal_reference(arch, mesh):
    m = MESHES[mesh]
    model, jmodel = Model(get_arch(arch), device="meta"), JModel(jget_arch(arch))
    for sh in SHAPES.values():
        want = jax.tree.leaves(
            jmodel.cache_pspecs(m, sh.global_batch, sh.seq_len),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        got = port_leaves_specs(model.cache_pspecs(m, sh.global_batch,
                                                   sh.seq_len))
        assert got == [tuple(s) for s in want], (arch, sh.name)


def port_leaves_specs(tree):
    """Spec tuples are leaves here."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in port_leaves_specs(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in port_leaves_specs(v)]
    return [tree]


def test_train_cfg_accumulation_equals_reference():
    cfg, jcfg = get_arch("llama3.2-1b"), jget_arch("llama3.2-1b")
    for sh in SHAPES.values():
        for m in MESHES.values():
            for unroll in (True, False):
                got = D._train_cfg(cfg, sh, m, unroll)
                want = JD._train_cfg(jcfg, sh, m, unroll)
                assert got.grad_accum == want.grad_accum
                assert got.opt.state_dtype == want.opt.state_dtype


# --------------------------------------------------------- the fake trace
def reduced_shape(kind: str) -> ShapeConfig:
    return ShapeConfig(f"reduced_{kind}", 32, 8, kind)


def test_record_layout_is_the_reference_s_and_report_reads_it():
    cfg = get_arch("llama3.2-1b").reduced()
    got = D.trace(cfg, reduced_shape("prefill"), (4, 2), ("data", "model"),
                  device="cpu")
    # the reference's record keys, with trace_s for lower_s and compile_s
    # and no code_bytes
    want_keys = {"n_devices", "kind", "n_params", "unrolled", "memory",
                 "roofline", "status", "trace_s"}
    assert set(got) == want_keys
    assert set(got["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    jroof = JRA.Roofline(1.0, 1.0, 1.0).to_dict()
    assert set(jroof) <= set(got["roofline"])
    res = {"llama3.2-1b|prefill_32k|16x16": {
        **got, "arch": "llama3.2-1b", "shape": "prefill_32k", "mesh": "16x16"}}
    rows = REP.roofline_rows(res)
    assert len(rows) == 1 and rows[0]["compile_s"] == got["trace_s"]
    assert "1/1 cells" in REP.dryrun_summary(res)


def test_training_accumulates_micro_batches_of_each_rank_s_rows():
    """The production accumulation (``unroll=False``: 2 micro-batches of
    each rank's 2 rows here), each rank's micro-batch its own rows: the
    trace runs the step twice and keeps the summed gradient laid out as
    the first."""
    cfg = get_arch("internvl2-1b").reduced()
    sh = reduced_shape("train")
    assert D._train_cfg(cfg, sh, FakeMesh((4, 2), ("data", "model")),
                        False).grad_accum == 2
    rec = D.trace(cfg, sh, (4, 2), ("data", "model"), device="cpu",
                  unroll=False)
    assert rec["status"] == "ok" and rec["unrolled"] is False
    kernels = rec["roofline"]["kernels"]
    assert kernels["flash_attention_bwd"]["calls"] == 2 * cfg.n_layers


@pytest.mark.parametrize("arch", ["xlstm-350m", "hymba-1.5b"])
def test_decode_with_more_model_ranks_than_heads(arch):
    """Heads that the model axis would cut (4 heads over 8 ranks) are made
    whole before the heads are split off."""
    rec = D.trace(get_arch(arch).reduced(), reduced_shape("decode"), (1, 8),
                  ("data", "model"), device="cpu")
    assert rec["status"] == "ok"


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_one_rank_trace_flops_equal_a_real_run(kind):
    cfg = get_arch("llama3.2-1b").reduced()
    sh = reduced_shape(kind)
    rec = D.trace(cfg, sh, (1, 1), ("data", "model"), device="cpu")
    model = Model(cfg, device="cpu")
    params = model.init_params(seed=0)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 32)),
                           dtype=torch.int32)
    if kind == "train":
        tcfg = D._train_cfg(cfg, sh, MESHES["16x16"], True)
        state = T.init_state(model, tcfg, torch.Generator().manual_seed(0))
        step = T.make_train_step(model, tcfg)
        roof = RA.analyze(step, state, {"tokens": toks, "labels": toks})
    elif kind == "prefill":
        roof = RA.analyze(model.prefill, params, {"tokens": toks}, 32)
    else:
        caches = model.init_cache(8, 32)
        roof = RA.analyze(model.decode_step, params, caches, toks[:, :1], 31)
    got = rec["roofline"]
    assert got["flops_by_type"] == roof.to_dict()["flops_by_type"]
    assert got["kernels"] == roof.kernels
    assert got["coll_bytes"] == 0


def test_full_width_decode_cell_traces_without_memory():
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    rec = D.run_cell("llama3.2-1b", "decode_32k", False, device="cpu")
    rise = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 - before
    model_bytes = 2 * rec["n_params"]                  # bf16
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rise < model_bytes / 10, (rise, model_bytes)
    # rank 0 holds its 1/256 of the batch's caches and its weight shards
    cache = 16 * 2 * 128 * 32768 * 8 * 64 * 2
    assert rec["memory"]["argument_bytes"] < (model_bytes + cache) / 16
    assert rec["roofline"]["kernels"]["decode_attention"]["calls"] == 16


def test_dryrun_refuses_while_a_group_is_up(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="process group is up"):
            D.trace(get_arch("llama3.2-1b").reduced(), reduced_shape("decode"),
                    (1, 1), ("data", "model"), device="cpu")
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------ the shape-only path
def same(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    return [(tuple(t.shape), t.dtype) for t in got] == [
        (tuple(t.shape), t.dtype) for t in want]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shape_only_outputs_match_the_plain_versions(dtype):
    """Each wrapper, given fake tensors, returns its outputs' shapes and
    dtypes alone (the plain versions run on real tensors of the same
    shapes) and counts no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    g = torch.Generator().manual_seed(0)

    def real(*shape, dt=dtype):
        return torch.randn(shape, generator=g).to(dt)
    b, s, h, kh, hd, bh, t, e, topk = 2, 64, 4, 2, 64, 4, 96, 16, 4
    q, k, v = real(b, s, h, hd), real(b, s, kh, hd), real(b, s, kh, hd)
    o, lse = ref.grouped_flash_ref(q, k, v, return_lse=True)
    lengths = torch.tensor([s, s // 2], dtype=torch.int32)
    sq, lf, ig = real(bh, s, hd), real(bh, s, dt=torch.float32), \
        real(bh, s, dt=torch.float32)
    logits = real(t, e)
    route = ref.moe_route_ref(logits, topk, capacity=8)
    want = [ref.grouped_flash_ref(q, k, v, return_lse=True),
            ref.grouped_flash_bwd_ref(q, k, v, o, lse, o),
            ref.grouped_decode_ref(q[:, :1], k, v, lengths),
            ref.mlstm_chunkwise_ref(sq, sq, sq, lf, ig),
            ref.mlstm_chunkwise_bwd_ref(sq, sq, sq, lf, ig, sq),
            tuple(route), ref.moe_topk_ref(logits, topk),
            ref.moe_route_bwd_ref(logits, route.idx, route.weights,
                                  route.weights)]
    mode = FakeTensorMode()
    fq, fk, fv, fo, flse, fl, fsq, flf, fig, flog, fidx, fw = (
        mode.from_tensor(x) for x in (q, k, v, o, lse, lengths, sq, lf, ig,
                                      logits, route.idx, route.weights))
    with mode:
        got = [KF.flash_attention(fq, fk, fv, return_lse=True),
               KF.flash_attention_bwd(fq, fk, fv, fo, flse, fo),
               KD.decode_attention(fq[:, :1].contiguous(), fk, fv, fl),
               KS.mlstm_scan(fsq, fsq, fsq, flf, fig),
               KS.mlstm_scan_bwd(fsq, fsq, fsq, flf, fig, fsq),
               tuple(KM.moe_route(flog, topk, capacity=8)),
               KM.moe_topk(flog, topk),
               KM.moe_route_bwd(flog, fidx, fw, fw)]
    for a, w in zip(got, want):
        assert same(a, w)
    for counter in (KF.launches, KF.bwd_launches, KD.launches, KS.launches,
                    KS.bwd_launches, KM.launches, KM.bwd_launches):
        assert counter.count == 0


# ----------------------------------------------------- hooks on gloo ranks
_HOOKS = """
import sys, numpy as np, torch, torch.distributed as dist
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{tmp}/init",
                        rank=rank, world_size=world)
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.transformer import Model
from repro_torch.models.weights import tree_map

mesh = make_mesh((1, world), ("data", "model"), device="cpu")
model = Model(get_arch("llama3.2-1b").reduced(), device="cpu")
params = model.init_params(seed=0)
toks = torch.as_tensor(np.random.default_rng(3).integers(
    0, model.cfg.vocab_size, (2, 16)), dtype=torch.int32)
want, caches = model.prefill(params, {"tokens": toks}, 24)
want_dec, _ = model.decode_step(params, caches, toks[:, :1], 16)
dparams = S.tree_map_with_path(lambda p, x: distribute_tensor(
    x, mesh, S.placements(S.param_spec(p, x, mesh), mesh)), params)
dtoks = distribute_tensor(toks, mesh, S.placements(S.batch_spec(toks, mesh),
                                                   mesh))
hooks = {"none": {}, "act_constraint": {"act_constraint": ("data", None, "model")},
         "attn_layout_constraint": {"attn_layout_constraint":
                                    ("data", None, "model", None)},
         "kv_update_constraint": {"kv_update_constraint":
                                  ("data", None, "model", None)}}
out = {}
for name, hook in hooks.items():
    for k, v in hook.items():
        setattr(model, k, v)
    with implicit_replication():
        got, dcaches = model.prefill(dparams, {"tokens": dtoks}, 24)
        dec, _ = model.decode_step(dparams, dcaches, dtoks[:, :1], 16)
    out[name] = [float((got.full_tensor() - want).abs().max()),
                 float((dec.full_tensor() - want_dec).abs().max())]
    for k in hook:
        setattr(model, k, None)
print("ERRS", out)
dist.destroy_process_group()
"""


def test_each_hook_on_two_gloo_ranks_matches_the_plain_run(tmp_path):
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_HOOKS), str(r), "2",
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=ROOT) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=150)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for out in outs:
        line = next(ln for ln in out.splitlines() if ln.startswith("ERRS"))
        errs = eval(line[5:])                          # noqa: S307
        assert set(errs) == {"none", "act_constraint",
                             "attn_layout_constraint", "kv_update_constraint"}
        for name, (prefill_err, decode_err) in errs.items():
            assert prefill_err < 2e-5, (name, prefill_err)
            assert decode_err < 2e-5, (name, decode_err)


# --------------------------------------------- hillclimb, fill_experiments
def test_hillclimb_and_fill_experiments_in_their_own_directory(
        tmp_path, monkeypatch):
    from repro_torch.roofline import hillclimb
    monkeypatch.chdir(tmp_path)
    for main, args in (
            (hillclimb.main, ["--only", "stablelm-3b|decode_32k|baseline",
                              "--device", "cpu"]),
            (D.main, ["--arch", "stablelm-3b", "--shape", "decode_32k",
                      "--multi-pod", "no", "--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", ["prog", *args])
        main()
    perf = json.loads((tmp_path / "results" / "perf.json").read_text())
    assert list(perf) == ["stablelm-3b|decode_32k|baseline"]
    assert perf["stablelm-3b|decode_32k|baseline"]["status"] == "ok"
    dry = json.loads((tmp_path / "results" / "dryrun.json").read_text())
    assert dry["stablelm-3b|decode_32k|16x16"]["status"] == "ok"
    # fails as the reference's does without EXPERIMENTS.md
    with pytest.raises(FileNotFoundError, match="EXPERIMENTS.md"):
        FILL.main()
    (tmp_path / "EXPERIMENTS.md").write_text(
        "# stub\n<!-- DRYRUN-SUMMARY -->\n<!-- ROOFLINE-TABLE -->\n"
        "<!-- ROOFLINE-NOTES -->\n<!-- PERF-TABLE -->\n")
    FILL.main()
    text = (tmp_path / "EXPERIMENTS.md").read_text()
    for name in ("DRYRUN-SUMMARY", "ROOFLINE-TABLE", "ROOFLINE-NOTES",
                 "PERF-TABLE"):
        assert f"<!-- BEGIN:{name} -->" in text and f"<!-- END:{name} -->" in text
    assert "stablelm-3b×decode_32k | baseline" in text
    assert "| stablelm-3b | decode_32k |" in text
    assert not torch.distributed.is_initialized()


def test_perf_table_equals_reference_in_the_ratio_of_the_constants(
        tmp_path, monkeypatch):
    rec = {"status": "ok", "n_devices": 256,
           "memory": {"argument_bytes": 3.5e9, "output_bytes": 1.25e9},
           "roofline": {"flops": 2.5e12, "coll_bytes": 4.0e9}}
    perf = {"stablelm-3b|decode_32k|baseline": rec,
            "stablelm-3b|decode_32k|kv_int8": {
                **rec, "roofline": {"flops": 2.4e12, "coll_bytes": 2.0e9}},
            "granite-8b|prefill_32k|act_dp": {"status": "error",
                                              "error": "ValueError: x"}}
    path = tmp_path / "perf.json"
    path.write_text(json.dumps(perf))
    # under the reference's constants the two tables are the same text
    monkeypatch.setitem(RA.PEAK_FLOPS, torch.bfloat16, JRA.PEAK_FLOPS)
    monkeypatch.setattr(RA, "HBM_BW", JRA.HBM_BW)
    monkeypatch.setattr(RA, "NVLINK_BW", JRA.ICI_BW)
    assert FILL.perf_table(str(path)) == JFILL.perf_table(str(path))
    assert "pending" in FILL.perf_table(str(tmp_path / "none.json"))
