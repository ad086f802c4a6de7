"""Three-term roofline of one call on one NVIDIA H100.

    compute term    = sum over types of flops / that type's peak (per card)
    memory term     = bytes / HBM bandwidth                     (per card)
    collective term = collective bytes / NVLink bandwidth       (per card)

The reference package reads its flops and bytes from the compiled step's
cost analysis and its collectives from the optimized HLO text.  PyTorch
runs eagerly, so ``analyze`` runs the call once and counts as it goes, in
one dispatch mode (``_Counter``):

* flops: the formulas of ``torch.utils.flop_counter`` over the dispatched
  operations (matrix products and convolutions), plus each hand-written
  kernel's own operations (``kernels.work``: the kernels are bound with
  ``ctypes`` and no dispatcher sees them), each at its own type: a float32
  product inside a bf16 step (a tied unembedding) runs at float32's peak;
* bytes: the operand and output bytes of every dispatched operation that
  is not a view -- the unfused count, which is what the reference's "bytes
  accessed" is on its CPU backend -- plus each kernel's bytes;
* collectives: the ``torch.distributed`` operations the call issues
  (``collective_bytes``), by kind, at their result's bytes: the in-place
  ``c10d`` operations of a process group, the functional collectives
  that DTensor and the MoE layer's exchange issue, and DTensor's own
  all-to-all between shard dims (``_dtensor::shard_dim_alltoall``); each
  operation's count and bytes also apart (``Roofline.coll_by_op``);
* the peak of the bytes that the call's operations allocate and hold at
  once (``Roofline.peak_bytes``): each fresh output storage counts from the
  operation that makes it until it is freed.  Under ``FakeTensorMode``
  this is the memory a step would hold, with nothing allocated.

Per rank.  On DTensors every count is rank 0's: an operation on DTensors
is handed on to DTensor, which runs it on the local shards, and the mode
counts those local operations and the collectives that redistribute them.
The global shapes that DTensor's sharding propagation runs for their
metadata are hidden from the count (``_propagation_hidden``).  So a
(256, 4096, 2048) x (2048, 8192) product placed on a 16 x 16 mesh counts
rank 0's 1/256 of its flops, not the global product's.

Hardware model, one H100 SXM (NVIDIA's data sheet, dense rates; the same
figures as the ``hopper-kernels`` table of this repository's kernels):
989 TFLOP/s bf16 and fp16, 67 TFLOP/s float32 outside the tensor cores,
3.35 TB/s HBM3, NVLink 900 GB/s to the other cards of the host, 450 GB/s
each way.  Those rates assume the card's full 700 W power limit, and
float32 products with TF32 off (``chip_smoke.py`` turns it off).

The analytic part -- ``analytic_memory_bytes``, ``active_params``,
``attn_model_flops``, ``model_flops`` -- is the reference's, held to its
numbers by the tests; ``count_params`` counts the port's parameter tree,
which a model on the ``meta`` device builds at full size without memory.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import work as W
from ..models.layers import dtype_of
from ..models.weights import tree_leaves

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}          # per card, by the step's type
HBM_BW = 3.35e12                             # bytes/s per card
NVLINK_BW = 450e9                            # bytes/s per card, each way

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# torch.distributed's operations as the dispatcher sees them, by the
# reference's collective kinds.  A process group's in-place operations
# hold their result in the first argument; a point-to-point receive stands
# in for collective-permute (a send has no result, and each permuted tensor
# is received once).  The functional collectives (DTensor's) return theirs.
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "recv_": "collective-permute", "recv_any_source_": "collective-permute",
}
_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# DTensor's own all-to-all, by which it moves a shard from one tensor dim
# to another on the card (on a CPU group it gathers and chunks instead)
_DTENSOR = {"shard_dim_alltoall": "all-to-all"}

# The queries of a tensor's layout, which ``FlopCounterMode`` also passes
# on uncounted.
_QUERIES = {getattr(torch.ops.aten, n).default for n in (
    "sym_is_contiguous", "is_contiguous", "is_strides_like_format",
    "is_non_overlapping_and_dense", "size", "sym_size", "stride",
    "sym_stride", "storage_offset", "sym_storage_offset", "numel",
    "sym_numel", "dim") if hasattr(torch.ops.aten, n)} | {
    torch.ops.aten.is_contiguous.memory_format, torch.ops.prim.layout.default}


def bound_ms(w: W.Work) -> tuple:
    """The least time the card could take for a kernel's ``Work``: the
    larger of its bytes over ``HBM_BW`` and its operations over the peak of
    its type, in ms, and which of the two it is ("bytes" or
    "operations")."""
    t_bytes = w.bytes / HBM_BW * 1e3
    t_ops = w.ops / PEAK_FLOPS[w.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"




def _tensor_bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _pytree_leaves(x)
               if isinstance(t, torch.Tensor))


def _is_dtensor(types) -> bool:
    return any(issubclass(t, DTensor) for t in types)


class _Counter(TorchDispatchMode):
    """Per rank (the module docstring says how): flops by the type each
    operation ran in, operand and output bytes of every operation that is
    not a view or an allocation, the collectives by kind, and the peak of
    the bytes the operations allocated and still hold.  Operations inside
    a counted kernel's entry point (``kernels.work``) add only to the
    peak: the kernel's own ``Work`` stands for them."""

    def __init__(self):
        super().__init__()
        self.by_type = {}
        self.bytes = 0
        self.coll = {k: 0 for k in _COLLECTIVES}
        self.counts = {k: 0 for k in _COLLECTIVES}
        self.by_op = {}
        self.live = 0
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES or _is_dtensor(types):
            return NotImplemented
        out = func(*args, **kwargs)
        self._hold(func, out)
        if W.hidden():
            return out
        table = {"c10d": _C10D, "_c10d_functional": _FUNCTIONAL,
                 "_dtensor": _DTENSOR}.get(func.namespace)
        if table is not None:
            name = func._schema.name.split("::")[-1]
            kind = table.get(name)
            if kind is not None:
                n = _tensor_bytes(args[0] if table is _C10D else out)
                self.coll[kind] += n
                self.counts[kind] += 1
                op = self.by_op.setdefault(name, {"count": 0, "bytes": 0})
                op["count"] += 1
                op["bytes"] += n
        elif not func.is_view and not func._schema.name.startswith(
                "aten::empty"):
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            n = formula(*args, **kwargs, out_val=out)
            dt = next((t.dtype for t in _pytree_leaves((args, kwargs))
                       if isinstance(t, torch.Tensor)
                       and t.is_floating_point()), None)
            self.by_type[dt] = self.by_type.get(dt, 0) + n
        return out

    def _hold(self, func, out) -> None:
        """Count each storage that ``func`` returns fresh (a result with no
        alias to an input) until it is freed."""
        rets = func._schema.returns
        outs = (out,) if len(rets) == 1 else out
        for ret, o in zip(rets, outs):
            if ret.alias_info is not None:
                continue
            for t in _pytree_leaves(o):
                if isinstance(t, torch.Tensor):
                    st = t.untyped_storage()
                    n = st.nbytes()
                    self.live += n
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def collectives(self) -> dict:
        out = dict(self.coll)
        out["total"] = sum(self.coll.values())
        out["counts"] = dict(self.counts)
        return out


@contextlib.contextmanager
def _propagation_hidden():
    """DTensor runs each new operation once on tensors of the global
    shapes (fake ones) to learn its output's metadata; no mode sees those
    runs inside the block, so the counts stay rank 0's.  A no-op where
    DTensor has not been imported."""
    import sys
    prop = sys.modules.get("torch.distributed.tensor._sharding_prop")
    if prop is None:
        yield
        return
    cls = prop.ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    orig = cls.__dict__[name]

    def hidden(self, *args, **kwargs):
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():
            return orig(self, *args, **kwargs)
    setattr(cls, name, hidden)
    try:
        yield
    finally:
        setattr(cls, name, orig)


def collective_bytes(fn, *args, by_op: bool = False, **kwargs) -> dict:
    """Per-collective-kind byte totals of the ``torch.distributed``
    operations that ``fn(*args, **kwargs)`` issues (each at its result's
    bytes), in the reference's layout: one key a kind, ``total`` and
    ``counts``; with ``by_op`` also each operation's count and bytes apart
    under that key."""
    with _Counter() as c:
        fn(*args, **kwargs)
    out = c.collectives()
    if by_op:
        out["by_op"] = {k: dict(v) for k, v in c.by_op.items()}
    return out


@dataclass
class Roofline:
    flops: float                  # per-card flops of the call, all types
    hbm_bytes: float              # per-card bytes accessed
    coll_bytes: float             # per-card collective bytes
    model_flops: float = 0.0      # 6*N*D (analytic, per card share)
    coll_detail: dict = field(default_factory=dict)
    dtype: torch.dtype = torch.bfloat16    # whose peak bounds the flops
    kernels: dict = field(default_factory=dict)   # name -> calls, ops, bytes
    # flops by the type each operation ran in; empty: all of type ``dtype``
    flops_by_type: dict = field(default_factory=dict)
    # the peak of the bytes the call's operations allocated and held
    peak_bytes: int = 0
    # each collective operation's count and bytes, by its name
    coll_by_op: dict = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        by_type = self.flops_by_type or {self.dtype: self.flops}
        return sum(f / PEAK_FLOPS[dt] for dt, f in by_type.items())

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_time(self) -> float:
        """Ideal overlapped execution: bounded by the slowest term."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization upper bound at the roofline time."""
        if self.roofline_time <= 0:
            return 0.0
        return (self.model_flops / PEAK_FLOPS[self.dtype]) / self.roofline_time

    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bottleneck": self.bottleneck,
            "mfu_bound": self.mfu_bound,
            "useful_flops_ratio": self.useful_flops_ratio(),
            "coll_detail": {k: v for k, v in self.coll_detail.items()
                            if k != "counts"},
            "coll_counts": self.coll_detail.get("counts", {}),
            "coll_by_op": self.coll_by_op,
            "dtype": str(self.dtype).replace("torch.", ""),
            "flops_by_type": {str(dt).replace("torch.", ""): f
                              for dt, f in self.flops_by_type.items()},
            "kernels": self.kernels, "peak_bytes": self.peak_bytes,
        }



def analyze(fn, *args, model_flops: float = 0.0, dtype=torch.bfloat16,
            **kwargs) -> Roofline:
    """Run ``fn(*args, **kwargs)`` once and count its flops by type, bytes,
    collectives and peak (the module docstring says how), rank 0's on
    DTensors; ``dtype`` is the step's type, whose peak prices the model
    flops.  On the card the call is synchronised before anything is read.
    Count in one run and time in another: the counting run is slower."""
    counter = _Counter()
    with W.recording() as calls, _propagation_hidden(), counter:
        fn(*args, **kwargs)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    by_type = dict(counter.by_type)
    kernels = {}
    for w in calls:
        by_type[w.dtype] = by_type.get(w.dtype, 0) + w.ops
        k = kernels.setdefault(w.name, {"calls": 0, "ops": 0, "bytes": 0})
        k["calls"] += 1
        k["ops"] += w.ops
        k["bytes"] += w.bytes
    coll = counter.collectives()
    if None in by_type:
        raise RuntimeError(f"flops without a type: {by_type}")
    return Roofline(
        flops=float(sum(by_type.values())),
        hbm_bytes=float(counter.bytes
                        + sum(k["bytes"] for k in kernels.values())),
        coll_bytes=float(coll["total"]), model_flops=model_flops,
        coll_detail=coll, dtype=dtype_of(dtype), kernels=kernels,
        flops_by_type={dt: float(f) for dt, f in by_type.items()},
        peak_bytes=counter.peak,
        coll_by_op={k: dict(v) for k, v in counter.by_op.items()})

def analytic_memory_bytes(cfg, shape, arg_bytes: float, out_bytes: float,
                          n_devices: int) -> float:
    """Analytic per-device HBM traffic per step (the reference's).

    The unfused count of ``analyze`` sums every operation's operands with
    no fusion and overstates HBM traffic; this analytic estimate is what
    the reference's roofline memory term uses.

    train   : params read fwd+bwd + grad write + opt m/v read/write
              (~2.5x resident argument bytes) + remat activation traffic
              (~12 x tokens x d x L x 2B: fwd save + bwd recompute + reads)
    prefill : params + activations (~6x) + cache writes (output bytes)
    decode  : params + full cache read (= argument bytes) + small writes
    """
    d, L = cfg.d_model, cfg.n_layers
    tokens_loc = shape.global_batch * shape.seq_len / n_devices
    if shape.kind == "train":
        return 2.5 * arg_bytes + 12.0 * tokens_loc * d * L * 2.0
    if shape.kind == "prefill":
        return arg_bytes + 6.0 * tokens_loc * d * L * 2.0 + out_bytes
    return arg_bytes + out_bytes / max(shape.seq_len, 1)


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS
# ---------------------------------------------------------------------------

def count_params(shapes_tree) -> int:
    """Parameters of a tree; at full size, give it the tree of a model on
    the ``meta`` device (``Model(cfg, device="meta").init_params()``):
    shapes without memory (deepseek-v3 has 671 B)."""
    return sum(int(x.numel()) for x in tree_leaves(shapes_tree))


def active_params(cfg, total_params: int) -> int:
    """MoE: only shared + top-k routed experts are active per token."""
    if cfg.moe is None:
        return total_params
    m = cfg.moe
    e = m.routed_total()
    # per-layer routed expert params
    per_expert = 3 * cfg.d_model * m.expert_ff
    n_moe_layers = cfg.n_layers - cfg.first_k_dense
    routed_total = e * per_expert * n_moe_layers
    routed_active = m.top_k * per_expert * n_moe_layers
    return total_params - routed_total + routed_active


def _attn_flops_per_token(cfg, ctx: float) -> float:
    """Score + AV matmul FLOPs per token at effective context ``ctx``."""
    d_attn = cfg.n_heads * cfg.hd
    n_attn = cfg.n_layers if cfg.family != "ssm" else 0
    per = 4.0 * d_attn * ctx * n_attn
    if cfg.family == "hybrid" and cfg.ssm is not None:
        # SSD heads: state update + readout ~ 4 * n * hd per head per token
        per += 4.0 * cfg.ssm.state_dim * cfg.hd * cfg.n_heads * cfg.n_layers
    if cfg.family == "ssm" and cfg.ssm is not None:
        di = cfg.ssm.expand * cfg.d_model
        hd = di // cfg.n_heads
        per += 4.0 * hd * hd * cfg.n_heads * cfg.n_layers   # matrix memory
    return per


def attn_model_flops(cfg, shape, n_devices: int) -> float:
    """Per-device analytic attention FLOPs for the whole step (the part a
    blocked attention kernel hides from a counter of dispatched
    operations)."""
    s, b = shape.seq_len, shape.global_batch
    if shape.kind in ("train", "prefill"):
        ctx = (min(s, cfg.sliding_window) if cfg.sliding_window else s) / 2.0
        per = _attn_flops_per_token(cfg, ctx)
        mult = 3.0 if shape.kind == "train" else 1.0
        return mult * b * s * per / n_devices
    ctx = min(s, cfg.sliding_window) if cfg.sliding_window else s
    per = _attn_flops_per_token(cfg, ctx)
    if cfg.family == "hybrid":
        d_attn = cfg.n_heads * cfg.hd
        per += 4.0 * d_attn * (s - cfg.sliding_window) * len(cfg.global_attn_layers)
    return b * per / n_devices


def model_flops(cfg, shape, params_total: int, n_devices: int) -> float:
    """Analytic useful FLOPs per device: 6*N*D train / 2*N*D forward over
    matmul params, plus attention context terms and the LM head where it is
    actually computed (prefill emits last-position logits only)."""
    n_act = active_params(cfg, params_total)
    vocab_d = cfg.vocab_size * cfg.d_model
    # Embedding gather costs ~no FLOPs. The unembed matmul costs 2*vocab_d
    # per logits-position whether the head is tied (reuses the table) or a
    # separate parameter -- n_body excludes both.
    n_body = n_act - vocab_d - (0 if cfg.tie_embeddings else vocab_d)
    head = 2.0 * vocab_d
    s = shape.seq_len
    b = shape.global_batch
    attn = attn_model_flops(cfg, shape, n_devices) * n_devices
    if shape.kind == "train":
        tokens = b * s
        total = 3.0 * tokens * (2.0 * n_body + head) + attn
    elif shape.kind == "prefill":
        tokens = b * s
        total = tokens * 2.0 * n_body + b * head + attn
    else:                                    # decode: one token per sequence
        total = b * (2.0 * n_body + head) + attn
    return total / n_devices
