"""Build the port's CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
its own by ``nvcc`` for Hopper (``sm_90a``) into a shared library under the
checkout's ``build/kernels/`` directory, which ``.gitignore`` lists.  A
library's file name carries a hash of its source, of every ``csrc/*.cuh``
header and of the compiler flags, so an edited source or header is rebuilt
and an unchanged one is reused; extra flags
(a diagnostic build's ``-D``) give a library of their own.  All missing
libraries are compiled in parallel, one ``nvcc`` process per source.

Serving threads may race to a kernel's first use, so the build runs under a
process-wide lock and, for other processes sharing the checkout, a file
lock.  Including no PyTorch header keeps a build to seconds (PyTorch's own
extension builder takes minutes); the wrappers pass raw device pointers and
the current stream, and every entry point returns ``cudaGetLastError()``.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from torch._subclasses.fake_tensor import FakeTensor

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict = {}


class LaunchCounter:
    """Launches of one kernel.  The wrapper adds one right after a launch
    that the driver accepted; nothing else adds to it."""

    def __init__(self) -> None:
        self.count = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
        "compiled at first use and need the CUDA toolkit")


def _lib_path(name: str, flags: tuple = ()) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # any source may include one
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None, flags: tuple = (), extra: tuple = ()) -> dict:
    """Compile every library in ``names`` (default: every ``csrc/*.cu``)
    that is not built yet, all at once, with ``flags`` added to
    ``NVCC_FLAGS``, and with them each ``(name, flags)`` of ``extra`` (a
    second build of a source, keyed ``"name flags"``).  Returns ``{name:
    (path, seconds, compiler_log)}``; a library that was already built
    reports 0 seconds and an empty log.  Raises ``RuntimeError`` with the
    compiler's output if a build fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = [(n, n, tuple(flags)) for n in names] + [
        (f"{n} {' '.join(f)}", n, tuple(f)) for n, f in extra]
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "lock", "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                return _build_locked(jobs)
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)


def _build_locked(jobs) -> dict:
    out, procs = {}, {}
    for key, name, flags in jobs:
        path = _lib_path(name, flags)
        if path.exists():
            out[key] = (path, 0.0, "")
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      path, tmp, time.perf_counter())
    failed = []
    for key, (proc, path, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{key} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        out[key] = (path, secs, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def function(lib: str, symbol: str, argtypes: list, flags: tuple = ()):
    """The C entry point ``symbol`` of library ``lib`` (built with the
    extra ``flags``), building and loading the library on first use.  Its
    result is a ``cudaError_t`` as int."""
    key = (lib, symbol, tuple(flags))
    fn = _libs.get(key)
    if fn is None:
        path, _, _ = build((lib,), flags)[lib]
        with _lock:
            fn = getattr(ctypes.CDLL(str(path)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[key] = fn
    return fn


def sass_counts(path, op: str) -> dict:
    """The SASS lines of each kernel of the built library ``path`` that
    hold ``op`` (``"HGMMA"``: tensor-core instructions; ``"TRAP"``), by
    mangled kernel name, from ``cuobjdump -sass`` beside ``nvcc``."""
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            out[name] = 0
        elif name and op in ln:
            out[name] += 1
    return out


def aligned16(t) -> bool:
    """Whether every (.., row) of ``t`` starts on 16 bytes: the kernels
    copy rows in 16-byte chunks.  A fake tensor has no address; its
    strides are checked alone."""
    es = t.element_size()
    if isinstance(t, FakeTensor):
        return all((st * es) % 16 == 0 for st in t.stride()[:-1])
    return (t.data_ptr() % 16 == 0
            and all((st * es) % 16 == 0 for st in t.stride()[:-1]))


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA kernel launch failed with "
                           f"cudaError_t {err}")
