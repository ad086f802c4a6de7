"""The port's sharded program run for real: DTensor train steps, decode
steps and the elastic checkpoint on gloo ranks on the CPU, against the
reference package's unsharded runs on the same weights.

Each multi-rank case starts its ranks as python processes on one gloo
group (``init_method`` a file under the test's ``tmp_path``), each joined
within its own timeout and killed if it is still up.  The ranks read the
reference's weights and batches from an ``.npz`` the test writes
(``params_from_numpy``'s leaves), place the state with
``sharding.device_put`` and dump ``full_tensor()`` results for the test to
compare.  The reference's own sharded tests do not run in jax 0.9 (its
micro-batch reshape raises ``ShardingTypeError`` under explicit sharding),
and a sharding is a layout of the same arithmetic, so the reference runs
unsharded.

A sharded step's micro-batch i is each data rank's i-th slice of its own
rows (data parallelism's accumulation); the reference is given the same
micro-batches: the batch's rows in that order (``micro_order``).  The MoE
layer plans over every token of the micro-batch, as the reference's does,
so which token a full expert drops is the same, and moves each routed row
to the rank of its expert's slot and back by all-to-alls; one layer is
also held alone, on several meshes and placements, gradients included.

Tolerances: each step's loss 1e-4 and every parameter leaf 1e-4 x max(1,
max |reference leaf|) after 3 steps (reductions over ranks and the
reference's sums run in other orders; Adam carries it), except an element
whose gradient was float noise at some step (below 1e-5 of its leaf's
largest): Adam's step normalises the gradient, so the noise's sign moves
such an element by up to the learning rate either way, and it is held
to 4 x the summed learning rates, at most 4 elements a run beyond 1e-4
(xlstm-350m's ``wq`` has one: a gradient of 3e-6 of its leaf's largest at
step 1); resume onto another mesh and onto a plain process within 1e-5 of
the uninterrupted loss, onto the same mesh bit for bit; decode logits
1e-4; one MoE layer's outputs, aux loss and gradients 2e-5 x max(1,
max |reference|) (float32, one layer: the reference's own layer
tolerance)."""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_arch
from repro.data.pipeline import SyntheticTokens
from repro.models.transformer import Model as JModel
from repro.training import checkpoint as JC
from repro.training import optimizer as JO
from repro.training import trainer as JT
from repro_torch.configs import get_arch as tget_arch
from repro_torch.distributed import sharding as S
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.moe import capacity as tcapacity
from repro_torch.models.transformer import Model as TModel
from repro_torch.models.weights import params_from_numpy, tree_leaves
from repro_torch.training import checkpoint as TC
from repro_torch.training import optimizer as TO
from repro_torch.training import trainer as TT

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=5)


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def leaves_close(got, want, tol, noise=None, reach=0.0):
    """Each leaf's max error within ``tol`` x max(1, max |want|).  With
    ``noise`` (a mask a leaf), an element whose gradient was float noise
    at some step is held to ``reach`` instead: Adam normalises a step by
    the gradient's own size, so such an element moves by up to the
    learning rate in a direction the noise picks, in either run.  Returns
    the worst ratio and the count of elements held to ``reach`` alone."""
    assert len(got) == len(want)
    worst, loose = 0.0, 0
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (a.shape, b.shape)
        if not a.size:
            continue
        err = np.abs(a - b) / max(1.0, float(np.max(np.abs(b))))
        if noise is not None:
            assert np.all(err[noise[i]] < reach), float(err[noise[i]].max())
            loose += int(np.sum(err[noise[i]] >= tol))
            err = np.where(noise[i], 0.0, err)
        worst = max(worst, float(err.max()))
    assert worst < tol, worst
    return worst, loose


def micro_order(b: int, dp: int, accum: int) -> list:
    """The rows of a (b, ...) batch in the order of the sharded step's
    micro-batches: micro-batch i holds each of the ``dp`` data ranks' i-th
    slice of its b / dp rows, rank after rank."""
    per, n = b // dp, b // dp // accum
    return [r * per + i * n + j for i in range(accum) for r in range(dp)
            for j in range(n)]


def _jax_model(arch):
    cfg = get_arch(arch).reduced()
    jm = JModel(cfg, backend="xla")
    return jm, jax.jit(jm.init_params)(jax.random.PRNGKey(0))


def _batches(vocab, steps, b, s):
    return [SyntheticTokens(vocab, seed=0).batch(i, 0, b, s)
            for i in range(steps)]


def _inputs(path, jp, batches, **extra):
    """The ``.npz`` the ranks read: the reference's parameter leaves in
    tree order (p0, p1, ...), each step's tokens and labels."""
    arrs = {f"p{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(jp))}
    for i, bt in enumerate(batches):
        arrs[f"tokens{i}"], arrs[f"labels{i}"] = bt["tokens"], bt["labels"]
    np.savez(path, **arrs, **extra)
    return len(jax.tree.leaves(jp))


# ----------------------------------------------------------- the ranks
_RANK = """
import json, sys
import numpy as np, torch, torch.distributed as dist
rank, world, case = int(sys.argv[1]), int(sys.argv[2]), json.load(open(sys.argv[3]))
out = case["out"]
dist.init_process_group("gloo", init_method=f"file://{out}/init-{case['tag']}",
                        rank=rank, world_size=world)
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.transformer import Model
from repro_torch.models.weights import tree_leaves, tree_map, tree_unflatten
from repro_torch.training import checkpoint as C, optimizer as O, trainer as T

mesh = make_mesh(case["mesh"], case["axes"], device="cpu")
cfg = get_arch(case["arch"]).reduced()
model = Model(cfg, device="cpu")
if "inputs" in case:
    inputs = np.load(case["inputs"])
    params = model.adopt(tree_unflatten(
        Model(cfg, device="meta").init_params(),
        [torch.from_numpy(inputs[f"p{i}"]) for i in range(case["n_params"])]))
res = {}


def whole(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def batch(i):
    b = {k: torch.from_numpy(inputs[f"{k}{i}"]) for k in ("tokens", "labels")}
    return S.device_put(b, S.batch_shardings(b, mesh), mesh)


def wq_of(state):
    found = []
    S.tree_map_with_path(lambda p, x: found.append(x)
                         if p[-2:] == ("wq", "w") else None, state["params"])
    wq = found[0]
    res["wq"] = {"placements": [repr(p) for p in wq.placements],
                 "local": wq.to_local().numel(), "numel": wq.numel()}


def placed(tcfg):
    state = {"params": params, "opt": O.init_state(tcfg.opt, params)}
    return S.device_put(state, S.state_shardings(state, mesh, ep=case["ep"]),
                        mesh)


def train():
    tcfg = T.TrainConfig(grad_accum=case["accum"],
                         opt=O.OptimizerConfig(**case["opt"]))
    state = placed(tcfg)
    before = [t.placements for t in tree_leaves(state)]
    step = T.make_train_step(model, tcfg)
    res["losses"] = []
    for i in range(case["steps"]):
        state, m = step(state, batch(i))
        assert not any(isinstance(v, DTensor) for v in m.values())
        res["losses"].append(float(m["loss"]))
    res["placements_kept"] = before == [t.placements
                                        for t in tree_leaves(state)]
    wq_of(state)
    leaves = [whole(t).float().numpy() for t in tree_leaves(state["params"])]
    if rank == 0:
        np.savez(f"{out}/params.npz", *leaves)


def elastic_save():
    tcfg = T.TrainConfig(opt=O.OptimizerConfig(**case["opt"]))
    state = placed(tcfg)
    step = T.make_train_step(model, tcfg)
    s1, m1 = step(state, batch(0))
    mgr = C.CheckpointManager(f"{out}/sharded", async_save=True)
    mgr.save(1, s1)
    mgr.wait()
    C.CheckpointManager(f"{out}/sharded_sync").save(1, s1)
    gathered = tree_map(whole, s1)           # every rank, in leaf order
    if rank == 0:
        C.CheckpointManager(f"{out}/unsharded").save(1, gathered)
    s2, m2 = step(s1, batch(1))
    restored = C.CheckpointManager(f"{out}/sharded").restore(1, state)
    res["restored_placements"] = [t.placements for t in tree_leaves(restored)
                                  ] == [t.placements for t in tree_leaves(state)]
    r2, mr = step(restored, batch(1))
    res["loss1"], res["loss2"], res["loss2_same_mesh"] = (
        float(m1["loss"]), float(m2["loss"]), float(mr["loss"]))


def elastic_restore():
    tcfg = T.TrainConfig(opt=O.OptimizerConfig(**case["opt"]))
    like = placed(tcfg)
    restored = C.CheckpointManager(case["ckpt"]).restore(1, like)
    res["restored_placements"] = [t.placements for t in tree_leaves(restored)
                                  ] == [t.placements for t in tree_leaves(like)]
    step = T.make_train_step(model, tcfg)
    s2, m2 = step(restored, batch(1))
    res["loss2"] = float(m2["loss"])
    wq_of(s2)


def decode():
    dparams = S.device_put(params, S.params_shardings(params, mesh), mesh)
    toks = torch.from_numpy(inputs["prompt"])
    b, smax = toks.shape[0], int(inputs["smax"])
    tokp = S.batch_shardings({"t": toks[:, :1]}, mesh)["t"]
    logits = []
    with implicit_replication():
        lg, caches = model.prefill(
            dparams, {"tokens": S.device_put(toks, S.batch_shardings(
                toks, mesh), mesh)}, smax)
        spec = model.cache_pspecs(mesh, b, smax)

        def place(c):
            return S.device_put(c, tree_map(lambda x, sp: S.placements(sp, mesh),
                                            c, spec), mesh)
        caches = place(caches)
        pos = toks.shape[1]
        for _ in range(case["steps"]):
            full = whole(lg).float()
            logits.append(full.numpy())
            tok = full[:, -1].argmax(-1).to(torch.int32)[:, None]
            lg, caches = model.decode_step(dparams, caches,
                                           S.device_put(tok, tokp, mesh), pos)
            caches = place(caches)
            pos += 1
        logits.append(whole(lg).float().numpy())
    if rank == 0:
        np.save(f"{out}/logits.npy", np.stack(logits))


def kernels():
    # K1 (each rank's query heads sharing one KV head where the mesh asks),
    # K3 and K4's top k through kernels.ops on DTensors: the largest error
    # of outputs and gradients against the plain calls
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(5)

    def r(*shape):
        return torch.randn(*shape, generator=g)
    lf = torch.nn.functional.logsigmoid(r(8, 40) + 2)
    calls = [(ops.grouped_flash, (r(4, 24, 8, 16), r(4, 24, 2, 16),
                                  r(4, 24, 2, 16))),
             (ops.mlstm_scan, (r(8, 40, 16), r(8, 40, 16), r(8, 40, 32), lf,
                               r(8, 40))),
             (lambda x: ops.moe_topk(x, 2, 6)[0], (r(32, 8),))]
    errs = []
    for fn, ins in calls:
        plain = [t.clone().requires_grad_(True) for t in ins]
        out = fn(*plain)
        dout = torch.randn(out.shape, generator=g)
        want = [out] + list(torch.autograd.grad((out * dout).sum(), plain))
        dts = [distribute_tensor(t, mesh, [Replicate()] * mesh.ndim)
               .requires_grad_(True) for t in ins]
        dout_d = fn(*dts)
        got = [dout_d] + list(torch.autograd.grad((dout_d * distribute_tensor(
            dout, mesh, dout_d.placements)).sum(), dts))
        errs.append(max(float((whole(a) - b).abs().max())
                        for a, b in zip(got, want)))
    res["errs"] = errs


def moe_layer():
    # one MoE layer forward and backward on DTensors for each variant:
    # the parameters placed with and without EP, the token rows over data
    # with d whole or over model; the outputs, aux loss, every gradient
    # and the plan the layer used
    import dataclasses
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import ops
    from repro_torch.models import moe as M
    plans = []
    route = ops.moe_route

    def spy(*a, **k):
        r = route(*a, **k)
        plans.append(r)
        return r
    ops.moe_route = spy
    for n, v in enumerate(case["variants"]):
        red = get_arch(v["arch"]).reduced()
        cfg = dataclasses.replace(red, moe=dataclasses.replace(
            red.moe, **v["routing"]))
        arrs = np.load(v["inputs"])
        p = {}
        for key in arrs.files:
            if key.startswith("p/"):
                node = p
                *head, last = key[2:].split("/")
                for h in head:
                    node = node.setdefault(h, {})
                node[last] = torch.from_numpy(arrs[key])
        pd = S.device_put(p, S.params_shardings(p, mesh, ep=v["ep"]), mesh)
        named = []
        S.tree_map_with_path(lambda path, t: named.append(
            ("/".join(map(str, path)), t.requires_grad_(True))), pd)
        leaves = [t for _, t in named]
        x = torch.from_numpy(arrs["x"])
        xpl = list(S.placements(S.batch_spec(x, mesh), mesh))
        if v["cols"]:
            xpl[mesh.mesh_dim_names.index("model")] = Shard(2)
        xd = distribute_tensor(x, mesh, xpl).requires_grad_(True)
        plans.clear()
        with implicit_replication():
            y, aux = M.moe_forward(cfg, pd, xd, capacity_factor=v["cf"])
            loss = (y * torch.from_numpy(arrs["dy"])).sum() + \
                float(arrs["aux_w"]) * aux
            grads = torch.autograd.grad(loss, [xd] + leaves)
        (r,) = plans
        got = {"y": whole(y), "aux": whole(aux), "slot": whole(r.slot),
               "idx": whole(r.idx)}
        got["g/x"] = whole(grads[0])
        got.update({f"g/{name}": whole(g) for (name, _), g in
                    zip(named, grads[1:])})
        if rank == 0:
            np.savez(f"{out}/moe{n}.npz",
                     **{k: t.float().numpy() if t.is_floating_point()
                        else t.numpy() for k, t in got.items()})


{"train": train, "elastic_save": elastic_save,
 "elastic_restore": elastic_restore, "decode": decode,
 "kernels": kernels, "moe_layer": moe_layer}[case["case"]]()
with open(f"{out}/res-{case['tag']}-{rank}.json", "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def run_ranks(tmp_path, world: int, case: dict, timeout: float = 240) -> list:
    """Run ``case`` on ``world`` gloo ranks; each rank's result dict."""
    case = {"out": str(tmp_path), "axes": ["data", "model"], "ep": False,
            "opt": OPT, **case}
    path = tmp_path / f"case-{case['tag']}.json"
    path.write_text(json.dumps(case))
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_RANK), str(r), str(world),
         str(path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=ROOT) for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [json.loads((tmp_path / f"res-{case['tag']}-{r}.json").read_text())
            for r in range(world)]


# ------------------------------------------------------------- training
def _reference_steps(jm, jp, batches, accum):
    """The reference's unsharded steps: the final state, each step's loss,
    and a mask a leaf of the elements whose gradient was float noise (below
    1e-5 of its leaf's largest) at some step, and the learning rates."""
    jcfg = JT.TrainConfig(grad_accum=accum, opt=JO.OptimizerConfig(**OPT))
    js = {"params": jp, "opt": JO.init_state(jcfg.opt, jp)}
    step = jax.jit(JT.make_train_step(jm, jcfg))
    grad = jax.jit(jax.grad(lambda p, b: jm.train_loss(p, b)[0]))
    losses, noise, lrs = [], None, []
    for bt in batches:
        n = bt["tokens"].shape[0] // accum
        g = [sum(np.asarray(x) for x in xs) for xs in zip(*(
            jax.tree.leaves(grad(js["params"], {k: v[i * n:(i + 1) * n]
                                                for k, v in bt.items()}))
            for i in range(accum)))]
        small = [np.abs(x) < 1e-5 * max(float(np.abs(x).max()), 1e-30)
                 for x in g]
        noise = small if noise is None else [a | b for a, b in zip(noise,
                                                                   small)]
        js, m = step(js, bt)
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
    return js, losses, noise, lrs


@pytest.mark.parametrize("arch,mesh,ep", [
    ("qwen2-0.5b", (4, 2), False),
    ("qwen2-moe-a2.7b", (2, 2), True),
    ("qwen2-moe-a2.7b", (4, 2), True),
    ("xlstm-350m", (2, 2), False)])
def test_train_step_on_gloo_ranks_matches_reference(tmp_path, arch, mesh, ep):
    """3 AdamW steps (grad_accum 2, batch 8 x 32) on a (data, model) mesh:
    each step's loss and the parameters after them against the
    reference's unsharded steps on the same micro-batches; the state keeps
    its placements, metrics come back plain, ``wq`` stays sharded over
    every rank."""
    accum, b, s, steps = 2, 8, 32, 3
    jm, jp = _jax_model(arch)
    batches = _batches(jm.cfg.vocab_size, steps, b, s)
    n = _inputs(tmp_path / "in.npz", jp, batches)
    res = run_ranks(tmp_path, mesh[0] * mesh[1], {
        "tag": "train", "case": "train", "arch": arch, "mesh": list(mesh),
        "ep": ep, "inputs": str(tmp_path / "in.npz"), "n_params": n,
        "accum": accum, "steps": steps})
    order = micro_order(b, mesh[0], accum)
    js, want, noise, lrs = _reference_steps(
        jm, jp, [{k: v[order] for k, v in bt.items()} for bt in batches],
        accum)
    for r in res:
        assert r["placements_kept"]
        assert r["losses"] == res[0]["losses"]
        # sharded over every rank: FSDP on d_in over data, TP on d_out
        assert r["wq"]["placements"] == ["Shard(dim=1)", "Shard(dim=2)"]
        assert r["wq"]["local"] * mesh[0] * mesh[1] == r["wq"]["numel"]
    for i, (got, w) in enumerate(zip(res[0]["losses"], want)):
        assert abs(got - w) < 1e-4, (i, got, w)
    got = np.load(tmp_path / "params.npz")
    # Adam moves an element at most about 2 lr a step: 4 x the sum bounds
    # the distance between two runs
    _, loose = leaves_close([got[f"arr_{i}"] for i in range(n)],
                            jax.tree.leaves(js["params"]), 1e-4, noise,
                            reach=4 * sum(lrs))
    assert loose <= 4, loose


def test_micro_order_puts_each_ranks_slices_together():
    assert micro_order(8, 4, 2) == [0, 2, 4, 6, 1, 3, 5, 7]
    assert micro_order(8, 2, 2) == [0, 1, 4, 5, 2, 3, 6, 7]
    assert micro_order(8, 1, 2) == list(range(8))


# ------------------------------------------------------------- elastic
def test_checkpoint_resumes_on_different_mesh(tmp_path):
    """Saved on (4, 2) after step 1, restored onto (4, 2), onto (2, 2)
    and as a plain state: step 2's loss the uninterrupted run's, bit for
    bit on the same mesh, within 1e-5 elsewhere; the sharded saves (sync
    and async) write the files of an unsharded save of the gathered
    state, which the reference restores in float32."""
    arch = "llama3.2-1b"
    jm, jp = _jax_model(arch)
    batches = _batches(jm.cfg.vocab_size, 2, 8, 16)
    n = _inputs(tmp_path / "in.npz", jp, batches)
    case = {"arch": arch, "inputs": str(tmp_path / "in.npz"), "n_params": n}
    a = run_ranks(tmp_path, 8, {**case, "tag": "save", "case": "elastic_save",
                                "mesh": [4, 2]})
    b = run_ranks(tmp_path, 4, {**case, "tag": "restore",
                                "case": "elastic_restore", "mesh": [2, 2],
                                "ckpt": str(tmp_path / "sharded")})
    for r in a + b:
        assert r["restored_placements"]
    for r in a:
        assert r["loss2_same_mesh"] == r["loss2"] == a[0]["loss2"]
    assert b[0]["wq"]["placements"] == ["Shard(dim=1)", "Shard(dim=2)"]
    assert b[0]["wq"]["local"] * 4 == b[0]["wq"]["numel"]
    # one plain process
    tcfg = TT.TrainConfig(opt=TO.OptimizerConfig(**OPT))
    tm = TModel(tget_arch(arch).reduced(), device="cpu")
    tp = tm.adopt(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    like = {"params": tp, "opt": TO.init_state(tcfg.opt, tp)}
    plain = TC.CheckpointManager(str(tmp_path / "sharded")).restore(1, like)
    _, m = TT.make_train_step(tm, tcfg)(plain, {
        k: torch.from_numpy(v) for k, v in batches[1].items()})
    want = a[0]["loss2"]
    for got in (b[0]["loss2"], float(m["loss"])):
        assert abs(got - want) < 1e-5, (got, want)
    # the files: byte-identical to the unsharded save
    ref_dir = tmp_path / "unsharded" / "step_00000001"
    names = sorted(os.listdir(ref_dir))
    for d in ("sharded", "sharded_sync"):
        got_dir = tmp_path / d / "step_00000001"
        assert sorted(os.listdir(got_dir)) == names
        for name in names:
            assert (got_dir / name).read_bytes() == \
                (ref_dir / name).read_bytes(), (d, name)
    # the reference reads them, in float32
    js = {"params": jp, "opt": JO.init_state(JO.OptimizerConfig(), jp)}
    jr = JC.CheckpointManager(str(tmp_path / "sharded")).restore(1, js)
    for x, y in zip(jax.tree.leaves(jr), tree_leaves(plain)):
        assert np.array_equal(np.asarray(x), y.numpy())


# --------------------------------------------------------------- decode
def test_decode_step_on_a_multi_pod_mini_mesh(tmp_path):
    """A (pod, data, model) = (2, 2, 2) mesh on 8 ranks: params by
    ``params_shardings``, caches by ``Model.cache_pspecs``; a prefill and
    4 greedy decode steps, logits within 1e-4 of the reference's and
    tokens identical."""
    arch, steps, smax = "llama3.2-1b", 4, 64
    cfg = get_arch(arch).reduced()
    jm = JModel(cfg)
    jp = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (8, 9)) \
        .astype(np.int32)
    n = _inputs(tmp_path / "in.npz", jp, [], prompt=toks, smax=smax)
    run_ranks(tmp_path, 8, {
        "tag": "decode", "case": "decode", "arch": arch,
        "mesh": [2, 2, 2], "axes": ["pod", "data", "model"],
        "inputs": str(tmp_path / "in.npz"), "n_params": n, "steps": steps})
    got = np.load(tmp_path / "logits.npy")
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks)}, smax)
    jdec = jax.jit(jm.decode_step)
    pos = toks.shape[1]
    for i in range(steps + 1):
        want = np.asarray(jl, np.float32)
        assert np.max(np.abs(got[i] - want)) < 1e-4, i
        if i == steps:
            break
        jt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        assert np.array_equal(jt[:, 0], got[i][:, -1].argmax(-1))
        jl, jc = jdec(jp, jc, jnp.asarray(jt), pos)
        pos += 1


# -------------------------------------------------------------- kernels
@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
def test_kernel_entries_under_local_map_give_the_plain_gradients(tmp_path,
                                                                  mesh):
    """K1, K3 and K4's top k on DTensors over 4 gloo ranks: batch rows
    over data, heads over model; on (1, 4) each rank's two query heads
    share one of the 2 KV heads, whose gradient then sums over the ranks
    that read it.  Outputs and gradients within 1e-5 of the plain calls'
    (the plain versions under ``local_map``'s autograd)."""
    res = run_ranks(tmp_path, 4, {"tag": "kernels", "case": "kernels",
                                  "arch": "llama3.2-1b", "mesh": list(mesh)})
    for r in res:
        assert len(r["errs"]) == 3 and max(r["errs"]) < 1e-5, r["errs"]


# -------------------------------------------------------- the MoE layer
# The reduced configs with the full ones' routing: qwen2-moe's 60 experts
# padded to 64, top 4; deepseek-v3's 256, top 8, scale 2.5; and qwen2-moe
# with 6 experts, top 2, which do not divide over a model axis of 4 (on
# (1, 4) EP leaves them whole and expert-TP cuts only their FF dim).
MOE_ROUTING = ("n_routed", "padded_routed", "top_k", "router_scale")
MOE_ARCHS = ("qwen2-moe-a2.7b", "deepseek-v3-671b")
MOE_ODD = {"n_routed": 6, "padded_routed": 0, "top_k": 2, "router_scale": 1.0}
MOE_MESHES = [(2, 2), (4, 2), (1, 4)]
MOE_VARIANTS = [(arch, ep, cols, cf) for arch in MOE_ARCHS + ("odd",)
                for ep in (True, False) for cols in (False, True)
                for cf in (1.25, 0.5)]
MOE_B, MOE_S, MOE_AUX = 4, 16, 0.37
_MOE_RUNS = {}


def _moe_cfgs(arch):
    """The layer's config in both packages."""
    import dataclasses
    out = []
    for get in (get_arch, tget_arch):
        base = get(MOE_ARCHS[0] if arch == "odd" else arch)
        red = base.reduced()
        out.append(dataclasses.replace(red, moe=dataclasses.replace(
            red.moe, **(MOE_ODD if arch == "odd" else {
                f: getattr(base.moe, f) for f in MOE_ROUTING}))))
    return out


def _flat(tree, prefix=""):
    """A nested dict's leaves by their "a/b/c" paths."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


_MOE_REF = {}


def _moe_reference(arch, cf):
    """The reference's layer on one process: its parameters (a router
    spread wide enough that experts fill up), the inputs, the outputs, the
    gradients of sum(y dy) + MOE_AUX aux, and the (token, expert) pairs its
    sort drops."""
    if (arch, cf) in _MOE_REF:
        return _MOE_REF[arch, cf]
    from repro.kernels import ref as jref
    from repro.models import moe as JMoE
    cfg, _ = _moe_cfgs(arch)
    m, d = cfg.moe, cfg.d_model
    rng = np.random.default_rng(11)
    jp = JMoE.moe_init(jax.random.PRNGKey(3), cfg)
    jp["router"]["w"] = jnp.asarray(rng.standard_normal(
        jp["router"]["w"].shape).astype(np.float32))
    x = rng.standard_normal((MOE_B, MOE_S, d)).astype(np.float32)
    dy = rng.standard_normal((MOE_B, MOE_S, d)).astype(np.float32)

    def loss(p, xx):
        y, aux = JMoE.moe_forward(cfg, p, xx, capacity_factor=cf,
                                  backend="xla")
        return (y * dy).sum() + MOE_AUX * aux, (y, aux)
    (_, (y, aux)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    # the reference's drops, by its own lines
    t, k = MOE_B * MOE_S, m.top_k
    _, idx = jref.moe_topk_ref(jnp.asarray(x.reshape(t, d)) @ jp["router"]["w"],
                               k, n_valid=m.n_routed)
    flat = idx.reshape(-1)
    order = jnp.argsort(flat)
    sizes = jnp.bincount(flat[order], length=m.routed_total())
    pos = jnp.arange(t * k) - (jnp.cumsum(sizes) - sizes)[flat[order]]
    cap = tcapacity(t, k, cf, m.routed_total())
    keep = np.asarray(pos < cap)
    order, idx = np.asarray(order), np.asarray(idx)
    drops = {(int(f // k), int(idx.reshape(-1)[f])) for f in order[~keep]}
    kept = {(int(f // k), int(idx.reshape(-1)[f])) for f in order[keep]}
    out = {"params": _flat(jp), "x": x, "dy": dy, "y": np.asarray(y),
           "aux": float(aux), "grads": {"x": np.asarray(gx), **_flat(gp)},
           "drops": drops, "kept": kept, "cap": cap}
    _MOE_REF[arch, cf] = out
    return out


def _moe_runs(tmp_path_factory, mesh):
    """Every variant of the layer on one set of gloo ranks of ``mesh``
    (cached a mesh): each variant's saved outputs, gradients and plan."""
    if mesh in _MOE_RUNS:
        return _MOE_RUNS[mesh]
    tmp = tmp_path_factory.mktemp("moe")
    variants = []
    for n, (arch, ep, cols, cf) in enumerate(MOE_VARIANTS):
        ref = _moe_reference(arch, cf)
        path = tmp / f"in{n}.npz"
        np.savez(path, x=ref["x"], dy=ref["dy"], aux_w=MOE_AUX,
                 **{f"p/{k}": v for k, v in ref["params"].items()})
        _, tcfg = _moe_cfgs(arch)
        variants.append({
            "arch": MOE_ARCHS[0] if arch == "odd" else arch, "ep": ep,
            "cols": cols, "cf": cf, "inputs": str(path),
            "routing": {f: getattr(tcfg.moe, f) for f in MOE_ROUTING}})
    res = run_ranks(tmp, mesh[0] * mesh[1], {
        "tag": "moe", "case": "moe_layer", "arch": MOE_ARCHS[0],
        "mesh": list(mesh), "variants": variants})
    runs = {}
    for n, v in enumerate(MOE_VARIANTS):
        got = dict(np.load(tmp / f"moe{n}.npz"))
        runs[v] = got
    _MOE_RUNS[mesh] = runs
    return runs


@pytest.mark.parametrize("variant", MOE_VARIANTS, ids=[
    f"{a.split('-')[0]}-{'ep' if ep else 'tp'}-{'dcut' if c else 'dwhole'}"
    f"-cf{cf}"
    for a, ep, c, cf in MOE_VARIANTS])
@pytest.mark.parametrize("mesh", MOE_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_moe_layer_exchange_on_gloo_ranks_matches_reference(
        tmp_path_factory, mesh, variant):
    """One MoE layer on DTensors over (data, model) gloo ranks -- experts
    over model (EP) or their FF dim (expert-TP), token rows over data with
    d whole or cut over model -- against the reference's unsharded layer on
    the same weights: the output, the aux loss and every gradient within
    2e-5 x max(1, max |reference|), and the same (token, expert) pairs
    dropped; at cf 0.5 an expert drops a token of one data rank after
    keeping another's."""
    arch, ep, cols, cf = variant
    got, ref = _moe_runs(tmp_path_factory, mesh)[variant], \
        _moe_reference(arch, cf)
    leaves_close([got["y"], got["aux"]], [ref["y"], np.float32(ref["aux"])],
                 2e-5)
    names = sorted(ref["grads"])
    assert sorted(k[2:] for k in got if k.startswith("g/")) == names
    leaves_close([got[f"g/{k}"] for k in names],
                 [ref["grads"][k] for k in names], 2e-5)
    _, tcfg = _moe_cfgs(arch)
    e, k = tcfg.moe.routed_total(), tcfg.moe.top_k
    slot, idx = got["slot"], got["idx"]
    drops = {(t, int(idx[t, c])) for t, c in zip(*np.nonzero(
        slot == e * ref["cap"]))}
    assert drops == ref["drops"]
    if cf < 1:
        t_rank = MOE_B * MOE_S // mesh[0]
        assert any(t // t_rank != u // t_rank for t, ex in drops
                   for u, ey in ref["kept"] if ex == ey) or mesh[0] == 1


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_collectives_are_the_exchange(arch):
    """Rank 0's collectives of one layer's forward and backward on a fake
    (2, 2) mesh with EP (``analysis.collective_bytes``, under
    ``FakeTensorMode``), token rows over data and d over model as the
    residual stream arrives, at T = 256 and 512 tokens and d = 64 and 128
    (T above d: DTensor picks the router product's layout by their sizes):
    the all-to-alls are four (two forward, their reverse backward), each
    of ``moe.exchange_bytes``; and no all-gather grows with the token rows
    or the slots (T d, E C d with C in proportion to T): the all-gather
    bytes have no T x d term (the logits' T E and the experts' E d f do
    not have one).  The routed experts alone: the shared expert's output
    arrives with its rows over model, and DTensor moves it to the routed
    output's layout by its own all-to-all on the card but by all-gather
    and chunk on a CPU group, which would count here as an all-gather."""
    import dataclasses
    import types
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import moe as TMoE
    from repro_torch.roofline import analysis as RA
    _, base = _moe_cfgs(arch)
    gathers = {}
    for b in (16, 32):
        for d in (64, 128):
            cfg = dataclasses.replace(base, d_model=d, moe=dataclasses.replace(
                base.moe, n_shared=0))
            m = cfg.moe
            with D.fake_group(4):
                mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
                with FakeTensorMode():
                    p = TMoE.moe_init(types.SimpleNamespace(
                        device=torch.device("meta")), cfg)
                    pd = D._place(p, mesh, lambda path, l: S.param_spec(
                        path, l, mesh, ep=True))
                    x = D._place({"x": torch.empty((b, MOE_S, d),
                                                   device="meta")}, mesh,
                                 lambda path, l: ("data", None, "model"))["x"]
                    leaves = [x.requires_grad_(True)] + [
                        t.requires_grad_(True) for t in tree_leaves(pd)]

                    def step():
                        with implicit_replication():
                            y, aux = TMoE.moe_forward(cfg, pd, x)
                            torch.autograd.grad(y.sum() + aux, leaves)
                    c = RA.collective_bytes(step, by_op=True)
            one = TMoE.exchange_bytes(b * MOE_S, m.top_k, 1.25,
                                      m.routed_total(), d, 4, rows=2,
                                      expert_parts=2)
            assert c["counts"]["all-to-all"] == 4, c
            assert c["by_op"]["all_to_all_single"] == {
                "count": 4, "bytes": 4 * one} and c["all-to-all"] == 4 * one, \
                (c, one)
            gathers[b, d] = c["all-gather"]
    td = gathers[32, 128] - gathers[32, 64] - gathers[16, 128] + \
        gathers[16, 64]
    assert td == 0, gathers


# ------------------------------------------------------- one process
@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group for the block (destroyed after it)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_to_host_of_a_dtensor_is_the_host_copy_of_its_whole(one_rank, dtype):
    from torch.distributed.tensor import Shard, distribute_tensor
    t = torch.randn(6, 4, generator=torch.Generator().manual_seed(0)).to(dtype)
    d = distribute_tensor(t, one_rank, [Shard(0), Shard(1)])
    got, want = TC.to_host(d), TC.to_host(t)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_restore_into_a_dtensor_keeps_its_placements(one_rank, tmp_path):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    tm = TModel(tget_arch("llama3.2-1b").reduced(), device="cpu")
    params = tm.init_params()
    state = {"params": params, "opt": TO.init_state(TO.OptimizerConfig(),
                                                    params)}
    TC.CheckpointManager(str(tmp_path / "ck")).save(3, state)
    plc = S.tree_map_with_path(
        lambda p, x: (Shard(0), Replicate()) if x.ndim else
        (Replicate(), Replicate()), state)
    like = S.device_put(state, plc, one_rank)
    got = TC.CheckpointManager(str(tmp_path / "ck")).restore(3, like)
    for g, l, w in zip(tree_leaves(got), tree_leaves(like),
                       tree_leaves(state)):
        assert isinstance(g, DTensor) and g.placements == l.placements
        assert g.dtype == w.dtype and torch.equal(g.full_tensor(), w)


def test_device_put_places_every_leaf_as_the_dry_run_does():
    """On a fake group of 8 ranks (rank 0's view of a (4, 2) mesh):
    ``device_put`` of real parameters, batch and caches gives each leaf
    the placements and local shape of the dry-run's fake placement."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models.weights import tree_map
    cfg = tget_arch("qwen2-moe-a2.7b").reduced()
    with D.fake_group(8):
        mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
        model = TModel(cfg, device="cpu")
        params = model.init_params()
        batch = {"tokens": torch.zeros((8, 32), dtype=torch.int32)}
        caches = model.init_cache(8, 64)
        spec = model.cache_pspecs(mesh, 8, 64)
        real = [S.device_put(params, S.params_shardings(params, mesh, ep=True),
                             mesh),
                S.device_put(batch, S.batch_shardings(batch, mesh), mesh),
                S.device_put(caches, tree_map(
                    lambda c, sp: S.placements(sp, mesh), caches, spec), mesh)]
        with FakeTensorMode():
            meta = TModel(cfg, device="meta")
            fake = [D._place(meta.init_params(), mesh, lambda p, l: S.param_spec(
                        p, l, mesh, ep=True)),
                    D._place({"tokens": torch.zeros((8, 32), dtype=torch.int32)},
                             mesh, lambda p, l: S.batch_spec(l, mesh)),
                    S.device_put(meta.init_cache(8, 64), tree_map(
                        lambda c, sp: S.placements(sp, mesh),
                        meta.init_cache(8, 64), spec), mesh)]
        for r, f in zip(real, fake):
            rl, fl = tree_leaves(r), tree_leaves(f)
            assert len(rl) == len(fl)
            for x, y in zip(rl, fl):
                assert x.placements == y.placements
                assert x.shape == y.shape
                assert x.to_local().shape == y.to_local().shape
        assert any(p.is_shard() for x in tree_leaves(real[0])
                   for p in x.placements)
