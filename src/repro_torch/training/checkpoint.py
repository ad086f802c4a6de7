"""Fault-tolerant checkpoints in the reference package's on-disk format:
atomic commit, async save, integrity hashes, auto-resume, retention.

Layout (one directory per step), as the reference writes it, so the two
packages can swap checkpoints:

    <dir>/step_00000123/
        manifest.json        # step, tree structure, per-leaf file, shape, dtype, sha256
        leaf-00000.npy ...   # one file per tree leaf

Leaves are numbered in the reference's tree order, which ``tree_leaves`` keeps:
dict entries by sorted key, lists in order.  A bfloat16 leaf is written as
the reference writes it -- a ``.npy`` of descr ``<V2`` holding the raw
bf16 bits, manifest dtype ``"bfloat16"``, the sha256 of those bytes -- so
its file is byte-identical to the reference's.  numpy has no bfloat16, so
on restore such a leaf is read from its bytes and viewed as bf16 (the
reference's own restore casts with ``astype`` there and fails, since numpy
has no cast from ``V2``; the port does not copy that).

Crash safety: leaves go into ``step_N.tmp``, each file fsync'd, and the
directory is renamed only after the manifest is written, so a
half-written checkpoint is never taken for a valid one.  ``async_save``
hands the host copy of the tree to a writer thread; ``keep_n`` keeps the
newest checkpoints and removes the rest.

Elastic: a state of DTensors (a sharded program) is saved as whole leaves,
gathered on every rank and written by one, into the files an unsharded
save of the same state writes; ``restore`` places each leaf as the tree it
is given places it, on any mesh, or as plain tensors.  So a run saved on
one mesh resumes on another, as the reference's checkpoints promise.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..distributed.sharding import device_put
from ..models.weights import tree_leaves, tree_unflatten

BF16_DESCR = "<V2"


def _leaf_name(i: int) -> str:
    return f"leaf-{i:05d}.npy"


def treedef_str(tree) -> str:
    """The tree's structure as the reference's manifest records it (its
    ``PyTreeDef`` text): ``*`` for a leaf, dicts by sorted key."""
    def walk(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(walk(v) for v in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(walk(v) for v in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return "None" if node is None else "*"
    return f"PyTreeDef({walk(tree)})"


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's host copy: a numpy array, or for bfloat16 its raw bits as
    ``int16`` (written out under the ``<V2`` descr).  A DTensor's is the
    host copy of its ``full_tensor()``: a collective, which every rank of
    its mesh calls, leaf by leaf in the same order."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy()
    return t.numpy()


def _mesh_of(leaves):
    """The mesh of a tree's DTensor leaves (one mesh over the whole default
    group), or None for a tree of plain tensors."""
    meshes = {t.device_mesh for t in leaves if isinstance(t, DTensor)}
    if not meshes:
        return None
    if len(meshes) > 1:
        raise ValueError("checkpoint: a tree's DTensors lie on more than "
                         "one mesh")
    mesh = meshes.pop()
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"checkpoint: the mesh holds {mesh.size()} of "
                         f"{dist.get_world_size()} ranks; a sharded save "
                         "spans the default group")
    return mesh


def write_leaf(f, arr: np.ndarray, bf16: bool) -> None:
    """One leaf's ``.npy`` file; a bf16 leaf with the reference's header."""
    if not bf16:
        np.save(f, arr)
        return
    np.lib.format.write_array_header_1_0(f, {
        "descr": BF16_DESCR, "fortran_order": False, "shape": arr.shape})
    f.write(arr.tobytes())


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3, async_save: bool = False,
                 verify_hashes: bool = True):
        self.dir = directory
        self.keep_n = keep_n
        self.verify_hashes = verify_hashes
        os.makedirs(directory, exist_ok=True)
        self._q: Optional[queue.Queue] = None
        self._thread = None
        self._errors: list = []
        self._sharded = False    # after a sharded save, wait ends at a barrier
        if async_save:
            self._q = queue.Queue(maxsize=2)
            self._thread = threading.Thread(target=self._writer, daemon=True)
            self._thread.start()

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree) -> None:
        """Save ``tree`` as step ``step``.  A sharded tree (DTensor leaves
        on one mesh, which spans the default process group) is a
        collective save: every rank calls it with its shards of the same
        state; each leaf is gathered whole (``to_host``) here, on the
        caller's thread, before anything reaches the writer thread, which
        runs no collective; the rank at the mesh's origin alone writes,
        collects and renames; every rank waits at a barrier before this
        returns (sync) or before ``wait`` returns (async).  The files are
        those of the same state saved unsharded, byte for byte."""
        leaves = tree_leaves(tree)
        mesh = _mesh_of(leaves)
        host = ([(to_host(t), t.dtype == torch.bfloat16) for t in leaves],
                treedef_str(tree))
        if mesh is not None:
            self._sharded = True
            if not all(c == 0 for c in mesh.get_coordinate()):
                if self._q is None:
                    dist.barrier()
                return
        if self._q is not None:
            self._q.put((step, host))
            return
        try:
            self._write(step, host)
        finally:
            if mesh is not None:
                dist.barrier()

    def wait(self) -> None:
        """Block until pending async saves are durable (on every rank,
        after a sharded save)."""
        if self._q is not None:
            self._q.join()
            if self._sharded:
                dist.barrier()
        if self._errors:
            raise RuntimeError(f"async checkpoint failed: {self._errors[0]}")

    def _writer(self) -> None:
        while True:
            step, host = self._q.get()
            try:
                self._write(step, host)
            except Exception as e:  # noqa: BLE001
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _write(self, step: int, host) -> None:
        leaves, treedef = host
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        entries = []
        for i, (arr, bf16) in enumerate(leaves):
            path = os.path.join(tmp, _leaf_name(i))
            with open(path, "wb") as f:
                write_leaf(f, arr, bf16)
                f.flush()
                os.fsync(f.fileno())
            entries.append({
                "file": _leaf_name(i),
                "shape": list(arr.shape),
                "dtype": "bfloat16" if bf16 else str(arr.dtype),
                "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            })
        manifest = {"step": step, "treedef": treedef, "leaves": entries}
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic commit
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> list:
        out = []
        for name in sorted(os.listdir(self.dir)):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like):
        """Restore into the structure of ``like`` (shape checked), each leaf
        in the type and on the device of ``like``'s; a DTensor leaf of
        ``like`` gives a DTensor of its mesh and placements, cut from the
        whole leaf that every rank reads (``sharding.device_put``).
        ``like``'s mesh may differ from the one that saved (the files hold
        whole leaves): the elastic rescale."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves_like = tree_leaves(like)
        if len(manifest["leaves"]) != len(leaves_like):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, "
                f"target structure has {len(leaves_like)}")
        out = []
        for i, (entry, ref) in enumerate(zip(manifest["leaves"], leaves_like)):
            arr = np.load(os.path.join(d, entry["file"]))
            if self.verify_hashes:
                h = hashlib.sha256(arr.tobytes()).hexdigest()
                if h != entry["sha256"]:
                    raise IOError(f"hash mismatch in {entry['file']} (corrupt checkpoint)")
            if list(arr.shape) != list(ref.shape):
                raise ValueError(f"leaf {i}: shape {arr.shape} != {tuple(ref.shape)}")
            if entry["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if isinstance(ref, DTensor):
                out.append(device_put(t.to(dtype=ref.dtype), ref.placements,
                                      ref.device_mesh))
            else:
                out.append(t.to(device=ref.device, dtype=ref.dtype))
        return tree_unflatten(like, out)

    def restore_latest(self, like):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like)
