"""Multi-pod dry-run: trace every (architecture x input shape x mesh) cell
against the production mesh without running it; record memory, the
roofline's counts and the collectives (the reference's
``launch/dryrun.py`` on the H100's terms).

PyTorch has no ahead-of-time compiler for 256 devices, so a cell is the
program of one rank (rank 0) traced once:

* over DTensor on a fake process group of 256 or 512 ranks
  (``torch.testing``'s ``FakeStore``, backend ``"fake"``), started for the
  cell and destroyed after it;
* under ``FakeTensorMode``, so nothing is allocated;
* with parameters, optimizer state, batch and caches as DTensors whose
  placements come from ``distributed.sharding``'s rules (and
  ``Model.cache_pspecs``);
* on ``device`` "cuda" by default, where the kernels' entry points take
  their kernel path with shapes alone (``kernels.ops``: ``local_map`` on
  each rank's shards, each wrapper's fake branch) and report their
  ``kernels.work`` counts; "cpu" traces the plain versions (the tests).

The record has the reference's layout, key for key, so that
``roofline.report`` reads it; ``run_cell``'s docstring says what each
number measures in place of XLA's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod both] [--jobs 6]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu --out results/dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..configs.base import SHAPES, all_archs, get_arch
from ..distributed import sharding as SH
from ..launch import specs as S
from ..launch.mesh import axis_sizes, make_mesh
from ..models.transformer import Model
from ..models.weights import tree_leaves, tree_map
from ..roofline import analysis as RA
from ..training import grad_compress
from ..training import optimizer as opt
from ..training import trainer as T

DEFAULT_OUT = "results/dryrun.json"
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _train_cfg(arch_cfg, shape, mesh, unroll: bool) -> T.TrainConfig:
    """Production config uses grad_accum=8 (microbatches bound activation
    memory); the unrolled roofline cells use accum=1, as the reference's do
    (there so that XLA's cost analysis sees the whole step).  ``mesh``: a
    DeviceMesh or a mesh-like object (``launch.mesh.axis_sizes``)."""
    if unroll:
        return T.TrainConfig(grad_accum=1,
                             opt=opt.OptimizerConfig(state_dtype="bfloat16"))
    sizes = axis_sizes(mesh)
    dp = 1
    for a in ("pod", "data"):
        dp *= sizes.get(a, 1)
    per_shard = max(shape.global_batch // dp, 1)
    accum = min(8, per_shard)
    while per_shard % accum:
        accum -= 1
    return T.TrainConfig(grad_accum=accum,
                         opt=opt.OptimizerConfig(state_dtype="bfloat16"))


def moe_exchange(cfg, shape, mesh, variant: dict | None = None,
                 unroll: bool = True) -> dict | None:
    """The MoE layers' all-to-alls in rank 0's program of a cell, by the
    formula of ``models/moe.py::_moe_sharded`` (``moe.exchange_bytes``):
    ``{"count": n, "bytes": n x one call's}``, or None for a model without
    MoE layers.  Each layer exchanges twice a forward (the rows, the
    outputs) and twice a backward; training runs ``grad_accum``
    micro-batches and, under remat, each layer's forward again; the tokens
    are a micro-batch's (decode: one a sequence), cut over the data axes
    where the batch divides, the experts over the model axis where the
    expert weights are cut over it (their expert dim under EP, their FF
    dim under expert-TP) and E divides."""
    from ..models.moe import exchange_bytes
    if cfg.moe is None:
        return None
    sizes = axis_sizes(mesh)
    dp = 1
    for a in ("pod", "data"):
        dp *= sizes.get(a, 1)
    tp = sizes.get("model", 1)
    accum, passes, cf = 1, 2, 1.25
    if shape.kind == "train":
        accum = _train_cfg(cfg, shape, mesh, unroll).grad_accum
        passes = 6 if cfg.remat else 4
    b = shape.global_batch // accum
    t = b * (1 if shape.kind == "decode" else shape.seq_len)
    if shape.kind == "decode":
        cf = 2.0
    e = cfg.moe.routed_total()
    cut = tp > 1 and e % tp == 0 and ((variant or {}).get("ep", False)
                                      or cfg.moe.expert_ff % tp == 0)
    rows = dp if dp > 1 and b % dp == 0 else 1
    one = exchange_bytes(t, cfg.moe.top_k, cf, e, cfg.d_model,
                         torch.finfo(getattr(torch, cfg.dtype)).bits // 8,
                         rows=rows, expert_parts=tp if cut else 1)
    n = (cfg.n_layers - cfg.first_k_dense) * accum * passes
    return {"count": n, "bytes": n * one}


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks (this process rank 0)
    for the block, destroyed after it.  Refuses to start while another
    group is up, which it would replace."""
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError("dryrun: a process group is up; the dry-run "
                           "starts a fake group of its own and will not "
                           "replace it")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _no_context_probe(device):
    """On the card, nothing allocated: ``FakeTensorMode`` makes a real
    one-element tensor at each fake CUDA tensor's creation, to be sure
    the CUDA context exists; the trace initialises CUDA itself (which
    allocates nothing) and skips that probe for the block."""
    from torch._subclasses import fake_tensor
    if torch.device(device).type != "cuda" or not hasattr(
            fake_tensor, "init_gpu_context"):
        yield
        return
    torch.cuda.init()
    probe = fake_tensor.init_gpu_context
    fake_tensor.init_gpu_context = lambda device: None
    try:
        yield
    finally:
        fake_tensor.init_gpu_context = probe


def _place(tree, mesh, spec_fn):
    """``tree`` placed on ``mesh`` by ``sharding.device_put`` (the real
    run's placement), each leaf by the spec ``spec_fn(path, leaf)``: a
    new empty shard of each leaf, fake under the dry-run's mode."""
    return SH.device_put(tree, SH.tree_map_with_path(
        lambda path, leaf: SH.placements(spec_fn(path, leaf), mesh), tree),
        mesh)


def local_bytes(tree) -> int:
    """Bytes of rank 0's shards of a tree's tensors (a plain tensor
    whole)."""
    from torch.distributed.tensor import DTensor
    n = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
    return n


def _variant_model(cfg, mesh, variant: dict, device) -> Model:
    sizes = axis_sizes(mesh)
    model = Model(cfg, device=device, kv_quant=variant.get("kv_quant", False))
    if variant.get("act_spec") is not None:
        model.act_constraint = tuple(variant["act_spec"])
    if variant.get("shardmap_attn"):
        from ..distributed.shardmap_attention import make_shardmap_gqa
        model.shardmap_attn = make_shardmap_gqa(mesh, cfg)
    if variant.get("attn_layout"):
        # the reference's (data, model) on the flattened (B*H, S, hd) flash
        # layout: batch over data, heads over model
        model.attn_layout_constraint = (
            "data" if "data" in sizes else None, None,
            "model" if "model" in sizes else None, None)
    if variant.get("kv_local_update"):
        dp = tuple(a for a in ("pod", "data") if a in sizes)
        model.kv_update_constraint = (
            dp if len(dp) > 1 else dp[0], None,
            "model" if cfg.n_kv_heads % sizes["model"] == 0 else None, None)
    return model


def trace(cfg, shape, mesh_shape, axes, *, device: str = "cuda",
          unroll: bool = True, variant: dict | None = None,
          pos: int | None = None, train_cfg: T.TrainConfig | None = None
          ) -> dict:
    """Trace one cell: ``cfg`` (an ArchConfig) x ``shape`` (a ShapeConfig)
    on a fake mesh of ``mesh_shape`` with ``axes``, rank 0's program on
    ``device``.  ``pos`` is the decode step's position (default
    ``shape.seq_len - 1``, the full cache); ``train_cfg`` replaces
    ``_train_cfg``'s (a caller's own training step).  Returns the record
    (``run_cell`` says what it holds), without the cell's names."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    variant = variant or {}
    n_dev = 1
    for d in mesh_shape:
        n_dev *= d
    with fake_group(n_dev), _no_context_probe(device):
        mesh = make_mesh(mesh_shape, axes, device=device)
        with FakeTensorMode(), implicit_replication():
            t0 = time.monotonic()
            model = _variant_model(cfg, mesh, variant, device)
            meta = Model(cfg, device="meta").init_params()
            n_params = RA.count_params(meta)
            ep = variant.get("ep", False)
            params = _place(meta, mesh, lambda p, l: SH.param_spec(
                p, l, mesh, ep=ep))
            kind, inputs = S.input_specs(cfg, shape, model)
            batch_spec = (lambda p, l: SH.batch_spec(l, mesh))
            if kind == "train":
                tcfg = train_cfg or _train_cfg(cfg, shape, mesh, unroll)
                if variant.get("compress"):
                    tcfg = T.TrainConfig(grad_accum=tcfg.grad_accum,
                                         compress_grads=True, opt=tcfg.opt)
                spec = (lambda p, l: SH.param_spec(p, l, mesh))
                state = {"params": params,
                         "opt": _place(opt.init_state(tcfg.opt, meta), mesh,
                                       spec)}
                if tcfg.compress_grads:
                    state["ef"] = _place(grad_compress.init_error_state(meta),
                                         mesh, spec)
                batch = _place(inputs[0], mesh, batch_spec)
                step = T.make_train_step(model, tcfg)
                args = (state, batch)
                fn = step
            elif kind == "prefill":
                batch = _place(inputs[0], mesh, batch_spec)
                args = (params, batch)

                def fn(params, batch):
                    return model.prefill(params, batch, shape.seq_len)
            else:
                caches, token = inputs
                spec_tree = model.cache_pspecs(mesh, shape.global_batch,
                                               shape.seq_len)
                caches = SH.device_put(caches, tree_map(
                    lambda c, sp: SH.placements(sp, mesh), caches, spec_tree),
                    mesh)
                token = _place(token, mesh, batch_spec)
                step_pos = shape.seq_len - 1 if pos is None else pos
                args = (params, caches, token)

                def fn(params, caches, token):
                    return model.decode_step(params, caches, token, step_pos)
            arg_bytes = local_bytes(args)
            box = {}
            mflops = RA.model_flops(cfg, shape, n_params, n_dev)
            roof = RA.analyze(lambda: box.update(out=fn(*args)),
                              model_flops=mflops, dtype=cfg.dtype)
            out_bytes = local_bytes(box.pop("out"))
            t_trace = time.monotonic() - t0
    peak = arg_bytes + roof.peak_bytes
    return {
        "n_devices": n_dev, "kind": kind, "n_params": n_params,
        "unrolled": unroll, "trace_s": round(t_trace, 1),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": peak - arg_bytes, "peak_bytes": peak},
        "roofline": roof.to_dict(), "status": "ok"}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             unroll: bool = True, variant: dict | None = None,
             device: str = "cuda") -> dict:
    """Trace one production cell (``trace``) and return its record, in the
    reference's layout.  What each number measures here:

    * ``trace_s`` -- the seconds of the fake trace (parameters placed,
      step traced, counts taken), in place of the reference's ``lower_s``
      and ``compile_s``; ``roofline.report``'s compile_s column reads it;
    * ``memory.argument_bytes`` / ``output_bytes`` -- the bytes of rank
      0's local shards of the step's inputs (parameters, optimizer state,
      batch; or caches and token) and outputs, from the placements: exact;
    * ``memory.peak_bytes`` -- the arguments plus the peak of the bytes
      the step's operations allocate and hold at once (fake storages,
      from their making to their freeing: ``roofline.analysis``), and
      ``temp_bytes`` that peak less the arguments.  XLA's ``code_bytes``
      has no counterpart and is left out;
    * ``roofline`` -- ``analysis.analyze`` of rank 0's program: flops by
      type, each kernel's ``kernels.work`` count from its local shapes,
      unfused bytes, the bytes of the collectives DTensor issues;
    * ``unrolled`` -- the argument, which sets the training step's
      accumulation (``_train_cfg``) as in the reference.  The port applies
      its layers one by one, so its counts cover every layer either way.

    The decode step is traced at ``pos = seq_len - 1`` (the full cache):
    the port's ``decode_step`` takes a host int.  ``variant``: the
    reference's perf knobs -- ``kv_quant`` (int8 KV cache), ``act_spec``
    (a spec of each layer's (B, S, d) input), ``ep`` (experts over the
    model axis), ``compress`` (int8 gradients with error feedback),
    ``shardmap_attn`` (the tensor-parallel GQA mixer), ``attn_layout``
    (the flash layout over data and model), ``kv_local_update`` (the new
    K/V placed as the cache before the write)."""
    shape_mesh, axes = MESHES[multi_pod]
    rec = trace(get_arch(arch), SHAPES[shape_name], shape_mesh, axes,
                device=device, unroll=unroll, variant=variant)
    return {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16", **rec}


def cells(arch: str | None = None, shape: str | None = None) -> list:
    """Every (arch, shape) cell of ``--all`` (``long_500k`` only for
    subquadratic archs), smallest models first so most cells land early;
    or the one named."""
    if arch is not None:
        return [(arch, shape)]
    out = []
    for a in all_archs():
        cfg = get_arch(a)
        for sname in SHAPES:
            if sname == "long_500k" and not cfg.is_subquadratic():
                continue
            out.append((a, sname))
    out.sort(key=lambda c: get_arch(c[0]).d_model * get_arch(c[0]).n_layers)
    return out


def _cell(arch: str, sname: str, mp: bool, unroll: bool, device: str):
    """One cell's record, an error's record in its place (``main``'s
    worker), and its seconds."""
    t0 = time.monotonic()
    try:
        res = run_cell(arch, sname, mp, unroll=unroll, device=device)
    except Exception as e:  # noqa: BLE001
        res = {"arch": arch, "shape": sname,
               "mesh": "2x16x16" if mp else "16x16",
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    return res, time.monotonic() - t0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["no", "yes", "both"], default="both")
    ap.add_argument("--unroll", choices=["yes", "no"], default=None,
                    help="default: yes for single-pod (roofline), no for multi-pod")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda: the kernel path, shapes alone; cpu: the "
                         "plain versions")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its "
                         "own (a trace is one thread of Python)")
    args = ap.parse_args()

    results = {}
    if args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    todo = cells() if args.all else cells(args.arch, args.shape)
    pods = {"no": [False], "yes": [True], "both": [False, True]}[args.multi_pod]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    t_all = time.monotonic()
    jobs = []
    for arch, sname in todo:
        for mp in pods:
            key = f"{arch}|{sname}|{'2x16x16' if mp else '16x16'}"
            if args.skip_existing and results.get(key, {}).get("status") == "ok":
                print(f"[skip] {key}")
                continue
            unroll = (not mp) if args.unroll is None else (args.unroll == "yes")
            jobs.append((key, (arch, sname, mp, unroll, args.device)))

    def record(key, res, seconds):
        print(f"[cell] {key}", flush=True)
        if res["status"] == "ok":
            r = res["roofline"]
            print(f"  ok in {seconds:.0f}s  "
                  f"compute={r['t_compute'] * 1e3:.2f}ms "
                  f"memory={r['t_memory'] * 1e3:.2f}ms "
                  f"coll={r['t_collective'] * 1e3:.2f}ms "
                  f"bottleneck={r['bottleneck']} "
                  f"useful={r['useful_flops_ratio']:.2f} "
                  f"peak={res['memory']['peak_bytes'] / 2**30:.2f}GB",
                  flush=True)
        else:
            print(f"  ERROR {res['error']}", flush=True)
        results[key] = res
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    if args.jobs > 1:
        import concurrent.futures as cf
        import multiprocessing
        with cf.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
            futures = {ex.submit(_cell, *a): key for key, a in jobs}
            for fut in cf.as_completed(futures):
                record(futures[fut], *fut.result())
    else:
        for key, a in jobs:
            record(key, *_cell(*a))
    n_ok = sum(1 for v in results.values() if v.get("status") == "ok")
    print(f"done: {n_ok}/{len(results)} cells ok -> {args.out} "
          f"in {time.monotonic() - t_all:.1f}s")


if __name__ == "__main__":
    main()
