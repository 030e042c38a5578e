"""Build, load and count the port's CUDA kernels.

Each source in `csrc/` is compiled by `nvcc` into its own shared library
with a plain C interface (no PyTorch headers: seconds per build, not
minutes) and loaded with ctypes. Builds happen at first use, never at
import, into `csrc/_build/` (listed in .gitignore); a library's file name
carries a hash of its source and flags, so an edited source rebuilds.
`build_all` starts one nvcc per source at once. A failed build raises.

Every wrapper that launches a kernel adds one to its `LaunchCounter` for
each launch, and does so nowhere else, so a run can show that its main
path went through the kernel. A wrapper counts when it enqueues; a CUDA
graph's replays enqueue nothing on the host, so the graph runner
(utils/graphs.py) takes back what its capture counted and adds that much
on every replay.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "_build"
# -fmad=false: no multiply-add contraction, so every product and sum rounds
# as the plain torch versions' separate ops do. The expand cull decision is
# compared bit for bit (csrc/expand.cu), and the two composite kernels share
# alpha.cuh, whose candidate decisions (expf included) must compile
# identically in both. A kernel that wants a fused multiply-add writes fmaf.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
)
SOURCES = ("expand", "composite_fwd", "composite_bwd", "segsum", "segsum_probe", "phase",
           "projection", "adam")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
COUNTERS: List["LaunchCounter"] = []
BUILD_LOG: Dict[str, str] = {}  # name -> nvcc's output (ptxas resource use)


class LaunchCounter:
    """A thread-safe count of kernel launches, in total and by an optional
    key (the composite counts both ways by channel width). Every counter made
    is listed in COUNTERS."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._by_key: Dict[object, int] = {}
        self._lock = threading.Lock()
        COUNTERS.append(self)

    def add(self, n: int = 1, key=None) -> None:
        with self._lock:
            self._n += n
            if key is not None:
                self._by_key[key] = self._by_key.get(key, 0) + n

    def snapshot(self) -> Tuple[int, Dict[object, int]]:
        """(total, by key) as they stand."""
        with self._lock:
            return self._n, dict(self._by_key)

    def since(self, before: Tuple[int, Dict[object, int]]) -> Tuple[int, Dict[object, int]]:
        """What the counts gained since `before` (a snapshot)."""
        n, keys = self.snapshot()
        return n - before[0], {k: v - before[1].get(k, 0) for k, v in keys.items()}

    def add_gain(self, gain: Tuple[int, Dict[object, int]], times: int = 1) -> None:
        """Add `times` x a gain (times = -1 takes it back)."""
        with self._lock:
            self._n += times * gain[0]
            for k, v in gain[1].items():
                self._by_key[k] = self._by_key.get(k, 0) + times * v
                if not self._by_key[k]:
                    del self._by_key[k]

    def reset(self) -> None:
        with self._lock:
            self._n = 0
            self._by_key = {}

    @property
    def by_key(self) -> Dict[object, int]:
        with self._lock:
            return dict(self._by_key)

    @property
    def count(self) -> int:
        return self._n


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = str(Path(home) / "bin" / "nvcc")
    if not Path(cand).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return cand


def _lib_path(name: str) -> Path:
    """The library's path, keyed by its source, the shared headers and the
    flags, so that an edit to any of them rebuilds."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Build the named kernels' libraries that are missing, one nvcc per
    source, all started together. Returns {name: seconds} for the builds
    run (empty if all were present)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo: List[str] = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = []
    t0 = time.perf_counter()
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    secs: Dict[str, float] = {}
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The kernel library `name`, built if needed, with each C function's
    argument types set from `signatures` (return type int: a cudaError_t)."""
    lib = _libs.get(name)
    if lib is not None:  # the usual case, without the lock
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


_NULL = contextlib.nullcontext()
_one_card = None  # whether this process sees exactly one CUDA device


def on_device(dev):
    """A context in which `dev` is the current CUDA device: nothing to
    enter where it already is (the usual case, and the cheap one: a
    wrapper's time on the host is part of a small kernel's cost)."""
    import torch

    global _one_card
    if _one_card is None:
        _one_card = torch.cuda.device_count() == 1
    if _one_card or torch.cuda.current_device() == dev.index:
        return _NULL
    return torch.cuda.device(dev)


_SMS: Dict[object, int] = {}


def multiprocessors(dev) -> int:
    """The card's multiprocessor count (asked once a device)."""
    import torch

    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def current_stream(dev) -> int:
    """The raw handle of PyTorch's current stream on `dev`, for a kernel
    launch (the short way where this PyTorch has it: a wrapper's time on the
    host is part of a small kernel's cost)."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None and dev.index is not None:
        return raw(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        lib.sgt_error_string.restype = ctypes.c_char_p
        lib.sgt_error_string.argtypes = [ctypes.c_int]
        msg = lib.sgt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
