"""The port's distributed layer against the reference package: every
leaf's sharding spec at full size on the 16x16 and 2x16x16 production
meshes (a mesh-like object with the reference's ``shape`` and
``axis_names``; no 256 devices needed), the specs as DTensor placements,
and, on CPU gloo groups of 2 or 4 ranks (each process joined within its own
time limit, the group initialised from a file under the test's own
directory): the tensor-parallel GQA mixer against the reference's
single-device GQA on the same weights (float32, 2e-5) and through
``Model.shardmap_attn`` against the reference's prefill logits (1e-4), its
gradients against the single-device path (2e-5), the fill-drain pipeline
against a sequential run, and ``compressed_psum`` against the reference's
shard_map result on the same inputs (the reference run in a subprocess
with 4 host devices, as the reference's own tests do); and the
collectives a 2-rank group issues, recorded by the roofline's
``collective_bytes``, against the reference's parser of the equivalent
HLO text."""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.distributed import sharding as JS
from repro.models import attention as JA
from repro.models.transformer import Model as JModel
from repro.roofline import analysis as JRA
from repro_torch.configs import all_archs, get_arch
from repro_torch.distributed import sharding as S
from repro_torch.distributed.shardmap_attention import expand_kv_weight
from repro_torch.launch import mesh as M
from repro_torch.models.transformer import Model

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")


class FakeMesh:
    """The two fields the sharding rules read, as the reference's mesh has
    them."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


MESHES = {"16x16": FakeMesh((16, 16), ("data", "model")),
          "2x16x16": FakeMesh((2, 16, 16), ("pod", "data", "model"))}


def port_leaves(tree, path=()):
    """(path, leaf) in the reference's flattening order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in port_leaves(tree[k],
                                                             path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in port_leaves(v, path + (i,))]
    return [(path, tree)]


def ref_path(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


@functools.lru_cache(maxsize=None)
def meta_params(arch: str):
    """The port's parameter tree at full size on the ``meta`` device."""
    return Model(get_arch(arch), device="meta").init_params()


@functools.lru_cache(maxsize=None)
def ref_shapes(arch: str):
    return jax.eval_shape(
        lambda: JModel(jget_arch(arch)).init_params(jax.random.PRNGKey(0)))


# ------------------------------------------------------------ spec rules
@pytest.mark.parametrize("ep", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", all_archs())
def test_param_spec_equals_reference_for_every_leaf(arch, mesh, ep):
    m = MESHES[mesh]
    want = [(ref_path(p), tuple(JS.param_spec(p, leaf, m, ep=ep)))
            for p, leaf in jax.tree_util.tree_flatten_with_path(
                ref_shapes(arch))[0]]
    tree = meta_params(arch)
    got = [(p, S.param_spec(p, leaf, m, ep=ep))
           for p, leaf in port_leaves(tree)]
    assert got == want
    placements = S.params_shardings(tree, m, ep=ep)
    for path, spec in got:
        node = placements
        for k in path:
            node = node[k]
        assert node == S.placements(spec, m)
    assert any(any(s) for _, s in got)         # something is sharded


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-moe-a2.7b",
                                  "deepseek-v3-671b", "xlstm-350m",
                                  "hymba-1.5b", "seamless-m4t-medium"])
def test_cache_and_batch_specs_equal_reference(arch, mesh, monkeypatch):
    from jax.sharding import PartitionSpec as P
    m = MESHES[mesh]
    # the reference's rules wrap each spec for a mesh of real devices
    monkeypatch.setattr(JS, "NamedSharding", lambda _, spec: spec)
    jcache = jax.eval_shape(lambda: JModel(jget_arch(arch)).init_cache(
        128, 32768))
    tcache = Model(get_arch(arch), device="meta").init_cache(128, 32768)
    want = [tuple(s) for s in jax.tree.leaves(
        JS.cache_shardings(jcache, m), is_leaf=lambda x: isinstance(x, P))]
    assert [S.cache_spec(x, m) for _, x in port_leaves(tcache)] == want
    jb = JS.batch_shardings({"tokens": np.zeros((256, 4096), np.int32)}, m)
    assert S.batch_spec(torch.zeros(256, 4096), m) == tuple(jb["tokens"])


def test_specs_become_placements():
    from torch.distributed.tensor import Replicate, Shard
    m = MESHES["2x16x16"]
    assert S.placements((None, ("pod", "data"), "model"), m) == (
        Shard(1), Shard(1), Shard(2))
    assert S.placements(("model", None), m) == (Replicate(), Replicate(),
                                                Shard(0))
    assert S.replicated(m) == (Replicate(),) * 3
    tree = meta_params("llama3.2-1b")
    pl = S.params_shardings(tree, MESHES["16x16"])
    wq = pl["segments"][0]["attn"]["wq"]["w"]      # (L, d, H hd)
    assert wq == (Shard(1), Shard(2))
    assert pl["embed"]["table"] == (Replicate(), Shard(1))
    assert M.dp_axes(m) == ("pod", "data") and M.tp_axis(m) == "model"
    assert M.axis_sizes(m) == {"pod": 2, "data": 16, "model": 16}


def test_expand_kv_weight_layout_equals_reference():
    from repro.distributed.shardmap_attention import (
        expand_kv_weight as jexpand)
    w = np.arange(4 * 2 * 3, dtype=np.float32).reshape(4, 6)
    got = expand_kv_weight(torch.from_numpy(w), 2, 3)
    assert np.array_equal(got.numpy(), np.asarray(jexpand(w, 2, 3)))


# ------------------------------------------------------ gloo process groups
def run_ranks(code: str, world: int, tmp_path, timeout: float = 150.0):
    """Run ``code`` on ``world`` processes (argv: rank, world, tmp_path),
    each joined within ``timeout`` seconds; returns their stdouts."""
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), str(r), str(world),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=ROOT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


_HEAD = """
import sys, numpy as np, torch, torch.distributed as dist
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{tmp}/init",
                        rank=rank, world_size=world)
"""

_MIXER = _HEAD + """
import dataclasses
from repro_torch.configs import get_arch
from repro_torch.distributed.shardmap_attention import make_shardmap_gqa
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as A
from repro_torch.models.transformer import Model
from repro_torch.models.weights import params_from_numpy

cfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(), qkv_bias=False)
mesh = make_mesh((1, world), ("data", "model"), device="cpu")
fwd = make_shardmap_gqa(mesh, cfg)
data = dict(np.load(f"{tmp}/in.npz"))
p = {n: {"w": torch.from_numpy(data[n])} for n in ("wq", "wk", "wv", "wo")}
x = torch.from_numpy(data["x"])
pos = torch.arange(x.shape[1])[None, :]
out = {}
for window in (0, 8):
    out[f"y{window}"] = fwd(p, x, pos, window).numpy()
# gradients through the mixer against the single-device path
xs = x.clone().requires_grad_(True)
ws = {n: {"w": v["w"].clone().requires_grad_(True)} for n, v in p.items()}
dy = torch.from_numpy(data["dy"])
(fwd(ws, xs, pos, 8) * dy).sum().backward()
out["dx"] = xs.grad.numpy()
for n in ws:
    out["d" + n] = ws[n]["w"].grad.numpy()
# the Model hook: prefill logits with it, on the reference's weights
model = Model(get_arch("llama3.2-1b").reduced(), device="cpu")
params = model.adopt(params_from_numpy(
    np.load(f"{tmp}/params.npy", allow_pickle=True).item(), device="cpu"))
model.shardmap_attn = make_shardmap_gqa(mesh, model.cfg)
toks = torch.from_numpy(data["tokens"])
logits, caches = model.prefill(params, {"tokens": toks}, 32)
out["logits"] = logits.numpy()
out["cache_k"] = caches[0]["k"].numpy()
# every leaf distributed by its placements, and gathered back whole
from torch.distributed.tensor import distribute_tensor
from repro_torch.distributed.sharding import params_shardings

def walk(t, pl):
    if isinstance(t, dict):
        return sum(walk(t[k], pl[k]) for k in t)
    if isinstance(t, list):
        return sum(walk(a, b) for a, b in zip(t, pl))
    d = distribute_tensor(t, mesh, pl)
    assert torch.equal(d.full_tensor(), t)
    return int(d.to_local().numel() < t.numel())
out["sharded_leaves"] = np.array(walk(params, params_shardings(params, mesh)))
np.savez(f"{tmp}/out{rank}.npz", **out)
dist.destroy_process_group()
"""


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def test_tensor_parallel_mixer_on_two_gloo_ranks_matches_reference(tmp_path):
    import jax.numpy as jnp
    jcfg = dataclasses.replace(jget_arch("llama3.2-1b").reduced(),
                               qkv_bias=False)
    p = jax.tree.map(np.array, JA.gqa_init(jax.random.PRNGKey(0), jcfg))
    x = rand((4, 32, jcfg.d_model), 1, 0.5)
    dy = rand((4, 32, jcfg.d_model), 2)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 24)) \
        .astype(np.int32)
    np.savez(tmp_path / "in.npz", x=x, dy=dy, tokens=toks,
             **{n: p[n]["w"] for n in ("wq", "wk", "wv", "wo")})
    jmodel = JModel(jget_arch("llama3.2-1b").reduced())
    jparams = jmodel.init_params(jax.random.PRNGKey(1))
    np.save(tmp_path / "params.npy",
            jax.tree.map(np.asarray, jparams), allow_pickle=True)
    run_ranks(_MIXER, 2, tmp_path)
    pos = jnp.arange(32)[None, :]
    want_logits, want_caches = jmodel.prefill(jparams,
                                              {"tokens": jnp.asarray(toks)}, 32)
    # single-device gradients of the port's own GQA, for the mixer's
    from repro_torch.models import attention as TA
    tcfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                               qkv_bias=False)
    xs = torch.from_numpy(x).requires_grad_(True)
    ws = {n: {"w": torch.from_numpy(p[n]["w"]).requires_grad_(True)}
          for n in ("wq", "wk", "wv", "wo")}
    (TA.gqa_forward(tcfg, ws, xs, torch.arange(32)[None, :], window=8)
     * torch.from_numpy(dy)).sum().backward()
    outs = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(2)]
    for got in outs:
        for window in (0, 8):
            want = np.asarray(JA.gqa_forward(jcfg, p, jnp.asarray(x), pos,
                                             window=window))
            assert np.abs(got[f"y{window}"] - want).max() < 2e-5
        assert np.abs(got["dx"] - xs.grad.numpy()).max() < 2e-5
        assert np.abs(got["logits"] - np.asarray(want_logits)).max() < 1e-4
        assert np.abs(got["cache_k"]
                      - np.asarray(want_caches[0]["k"])).max() < 1e-4
    assert int(outs[0]["sharded_leaves"]) > 0
    # each rank holds its own heads' part of the weights' gradients
    for n in ("wq", "wk", "wv", "wo"):
        total = outs[0]["d" + n] + outs[1]["d" + n]
        assert np.abs(total - ws[n]["w"].grad.numpy()).max() < 2e-5, n
        assert not np.array_equal(outs[0]["d" + n], outs[1]["d" + n])


_PIPE = _HEAD + """
from repro_torch.distributed.pipeline_parallel import make_pipelined_fn
from repro_torch.launch.mesh import make_mesh
data = np.load(f"{tmp}/in.npz")
ws, x = torch.from_numpy(data["ws"]), torch.from_numpy(data["x"])
mesh = make_mesh((world,), ("pod",), device="cpu")
run = make_pipelined_fn(lambda w, xb: torch.tanh(xb @ w), mesh, world)
np.save(f"{tmp}/out{rank}.npy", run(ws, x).numpy())
dist.destroy_process_group()
"""


def test_pipeline_on_two_gloo_ranks_matches_sequential(tmp_path):
    n_stages, n_micro, mb, d = 2, 6, 2, 16
    ws = rand((n_stages, d, d), 4, 0.3)
    x = rand((n_micro, mb, d), 5)
    np.savez(tmp_path / "in.npz", ws=ws, x=x)
    run_ranks(_PIPE, n_stages, tmp_path)
    want = torch.from_numpy(x)
    for s in range(n_stages):
        want = torch.tanh(want @ torch.from_numpy(ws[s]))
    for r in range(n_stages):
        got = np.load(tmp_path / f"out{r}.npy")
        assert np.abs(got - want.numpy()).max() < 1e-6


_CPSUM = _HEAD + """
from repro_torch.training.grad_compress import compressed_psum
x = torch.from_numpy(np.load(f"{tmp}/x.npy")[rank])
np.save(f"{tmp}/out{rank}.npy", compressed_psum(x).numpy())
dist.destroy_process_group()
"""

_CPSUM_REF = """
import sys, numpy as np, jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.training.grad_compress import compressed_psum
mesh = jax.make_mesh((4,), ("pod",))
x = jnp.asarray(np.load(sys.argv[1]))
f = shard_map(lambda a: compressed_psum(a[0], "pod"), mesh=mesh,
              in_specs=P("pod"), out_specs=P())
np.save(sys.argv[2], np.asarray(f(x)))
"""


def test_compressed_psum_on_four_gloo_ranks_matches_reference(tmp_path):
    x = rand((4, 128), 6)
    np.save(tmp_path / "x.npy", x)
    env = {**os.environ, "PYTHONPATH": SRC,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    ref = subprocess.run([sys.executable, "-c", _CPSUM_REF,
                          str(tmp_path / "x.npy"), str(tmp_path / "ref.npy")],
                         capture_output=True, text=True, env=env,
                         timeout=150)
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = np.load(tmp_path / "ref.npy")
    run_ranks(_CPSUM, 4, tmp_path)
    step = np.abs(x).max() / 127.0
    for r in range(4):
        got = np.load(tmp_path / f"out{r}.npy")
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        assert np.abs(got - x.sum(0)).max() <= 4 * step / 2 + 1e-6


# The collectives each of 2 gloo ranks issues, and the HLO text of the
# same collectives at their result shapes (tests/test_roofline.py's).
_COLLECTIVES = _HEAD + r"""
from repro_torch.roofline import analysis as RA

def issue():
    out = torch.empty(4, 1024, 512, dtype=torch.bfloat16)
    dist.all_gather_into_tensor(out, torch.ones(2, 1024, 512,
                                                dtype=torch.bfloat16))
    dist.all_reduce(torch.ones(2048))
    dist.reduce_scatter_tensor(torch.empty(128), torch.ones(256))
    small = torch.empty(128, 16, dtype=torch.bfloat16)
    dist.all_gather_into_tensor(small, torch.ones(64, 16,
                                                  dtype=torch.bfloat16))
    got = torch.empty(1024, dtype=torch.uint8)
    for r in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, torch.ones(1024, dtype=torch.uint8),
                       1 - rank),
            dist.P2POp(dist.irecv, got, 1 - rank)]):
        r.wait()
    torch.mm(torch.ones(128, 128), torch.ones(128, 128))

import json
print(json.dumps(RA.collective_bytes(issue)))
dist.destroy_process_group()
"""

HLO = """
HloModule step
%all-gather.3 = bf16[4,1024,512]{2,1,0} all-gather(%param.1), dimensions={0}
%ar = f32[2048]{0} all-reduce(%x), to_apply=%add
%rs.1 = f32[128]{0} reduce-scatter(%a), dimensions={0}
%ag.s = bf16[128,16]{1,0} all-gather-start(%p), dimensions={0}
%ag.d = bf16[128,16]{1,0} all-gather-done(%ag.s)
%cp = u8[1024]{0} collective-permute(%y), source_target_pairs={{0,1},{1,0}}
%dot.5 = f32[128,128]{1,0} dot(%l, %r)
"""


def test_collective_bytes_on_gloo_match_reference_parser(tmp_path):
    want = JRA.collective_bytes(HLO)
    for out in run_ranks(_COLLECTIVES, 2, tmp_path):
        got = json.loads(out.strip().splitlines()[-1])
        assert got == want
