"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded through ``ctypes`` (no PyTorch headers, so a build
takes seconds). Libraries go to ``build/torch_kernels/`` beside the
package, named by a hash of the source, the shared ``csrc/*.cuh`` headers
and the flags, so an edited source
rebuilds and an unchanged one is reused. Nothing here runs at import time:
the first call of a kernel's wrapper builds it (:func:`launcher`), or
:func:`build` builds a set of kernels up front, one ``nvcc`` process per
source, all at once. Inside :func:`defined` the kernels are built and
launched with extra preprocessor macros (an instrumented build, e.g. the
phase clocks of ``phase_clocks.py``), as libraries of their own beside the
plain ones. Also here: what every wrapper shares — its launch counter
(:class:`LaunchCounts`), the check of a tensor it passes by pointer
(:func:`check_operand`, its dtype included), and the lock held while a CUDA graph is captured
(:data:`CAPTURE_LOCK`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
import weakref
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
# every kernel source of the port (csrc/<name>.cu), the set build() takes
SOURCES = ("decode_window", "decode_window_bf16", "spec_window",
           "spec_window_bf16", "lstm_fwd", "lstm_bwd", "lstmx_fwd",
           "lstmx_bwd", "lstm_tiled_fwd", "lstm_tiled_bwd")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
# Held while a CUDA graph is being captured (train/graphs.py). A thread
# that allocates pinned memory or copies on another stream
# (data/prefetch.py) takes it too: such calls from any thread invalidate a
# capture in progress.
CAPTURE_LOCK = threading.Lock()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_defines: tuple[str, ...] = ()  # macros of the current build (defined())
_loaded: dict[tuple, ctypes.CDLL] = {}  # by (name, macros)
_launchers: dict[tuple, object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def _flags() -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{m}" for m in _defines)


@contextlib.contextmanager
def defined(*macros: str):
    """Inside the block, kernels build and launch with ``macros`` defined
    (``nvcc -D``): libraries of their own (the flags are in the hash), so
    the plain build is untouched and comes back after the block."""
    global _defines
    saved, _defines = _defines, tuple(macros)
    try:
        yield
    finally:
        _defines = saved


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library goes: named by a hash of its source
    (with the sources it includes, as ``<name>_bf16.cu`` includes
    ``<name>.cu``), the shared headers of ``csrc/`` and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for inc in re.findall(rb'#include "(\w+\.cu)"', src):
        src += (CSRC / inc.decode()).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(_flags()).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names) -> float:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns the wall seconds spent; raises
    ``RuntimeError`` with the compiler's output when a build fails. The
    compiler's resource report (``-Xptxas -v``) is kept beside each
    library as ``<library>.log``."""
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in dict.fromkeys(names)  # each source once
                if not library_path(n).is_file()]
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for n in todo:
            out = library_path(n)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *_flags(), "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs.append((n, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for n, out, tmp, proc in procs:
            log, _ = proc.communicate()
            out.with_name(out.name + ".log").write_text(log)
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu (rc {proc.returncode}):"
                              f"\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)  # atomic: concurrent builds agree
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


class LaunchCounts:
    """Plain integer counters of one kernel's wrapper: ``kernel`` counts
    CUDA launches, ``reference`` counts calls that ran the plain version
    (CPU tensors). Increments are under a lock. Every counter is listed in
    :meth:`every` by its ``name``, so that a captured CUDA graph
    (``train/graphs.py``) can record the launches its capture made and add
    them again on each replay, where no wrapper runs."""

    _every: "weakref.WeakSet[LaunchCounts]" = weakref.WeakSet()

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.kernel = 0
        self.reference = 0
        LaunchCounts._every.add(self)

    @classmethod
    def every(cls) -> list["LaunchCounts"]:
        return list(cls._every)

    def bump(self, field: str) -> None:
        self.add(field, 1)

    def add(self, field: str, n: int) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def reset(self) -> None:
        with self._lock:
            self.kernel = 0
            self.reference = 0


def check_operand(name: str, t, shape, device, dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    on ``device`` — what every kernel wrapper checks before it passes a
    pointer (``TypeError`` for another dtype: a kernel reads its operands
    as the dtype its build takes, and a mixed call never converts)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_f32(name: str, t, shape, device) -> None:
    """:func:`check_operand` of a float32 tensor: an operand that is float32
    in every form of its kernel (the carries, the bias, the head)."""
    check_operand(name, t, shape, device, torch.float32)


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built first if
    needed."""
    key = (name, _defines)
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[key] = lib
    return lib


_clusters: dict[tuple, int] = {}


def max_clusters(name: str, dev, cluster: int, smem: int) -> int:
    """How many clusters of ``cluster`` blocks of kernel ``name``, each
    block asking for ``smem`` bytes of shared memory, the card ``dev``
    keeps resident at once: its C entry point ``<name>_max_clusters(C,
    smem, &out)`` asks the CUDA runtime (once per kernel, card, size and
    bytes). Raises if the runtime fails."""
    key = (name, dev.index or 0, cluster, smem)
    n = _clusters.get(key)
    if n is None:
        fn = getattr(load(name), f"{name}_max_clusters")
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = fn(cluster, smem, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"{name}: cudaOccupancyMaxActiveClusters "
                               f"failed: CUDA error {rc} (cluster={cluster})")
        n = _clusters[key] = out.value
    return n


def launcher(name: str, argtypes, entry: str = "launch"):
    """The C entry point ``<name>_<entry>`` of kernel ``name`` (built and
    loaded first if needed; ``entry`` names a second form of the source,
    e.g. ``"bf16_launch"``), with ``argtypes`` set and an int result: the
    CUDA error code of the launch."""
    key = (name, entry, _defines)
    fn = _launchers.get(key)
    if fn is not None:
        return fn
    lib = load(name)
    with _lock:
        fn = _launchers.get(key)
        if fn is None:
            fn = getattr(lib, f"{name}_{entry}")
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _launchers[key] = fn
    return fn
