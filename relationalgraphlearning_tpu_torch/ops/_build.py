"""How every CUDA source of ``csrc/`` is built and loaded.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for sm_90a into a shared library
with a plain C interface, loaded with ``ctypes``. The library's name carries
the hash of the source, of the headers it may include (``csrc/*.cuh``) and
of the flags, so an edited source builds anew. Libraries go to the
git-ignored ``_build/`` at first use. ``build_all`` starts one ``nvcc`` per
source, all at once, and waits for them together (the span ``ops.build``;
the counters ``ops.builds.compiled`` and ``ops.builds.cached``).

A wrapper module declares its source once as a ``Library``: the C entry
points with their argument types, and the kernels it launches. Nothing is
built or loaded until a wrapper first calls it on CUDA tensors.

The launch registry: every kernel wrapper counts its launches here, by
kernel name (``count_launch``), from the import of its module on.
``launch_counts`` reads every kernel's count, ``reset_launch_counts`` zeroes
them all. The counts move in Python at each launch, so they move while a
CUDA graph is captured and never at a replay (``captured.Graphed``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from relationalgraphlearning_tpu_torch.utils import profiling

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Dynamic shared memory a block may opt into on Hopper (sm_90): 227 KB.
MAX_SMEM_BYTES = 232_448

_loaded: dict = {}
_load_lock = threading.Lock()   # ranks run as threads load at once
_launches: dict = {}            # kernel name -> launches
_count_lock = threading.Lock()  # ... and count their launches at once


def count_launch(kernel: str) -> None:
    """One more launch of ``kernel`` (ranks as threads count into the same
    registry during one capture)."""
    with _count_lock:
        _launches[kernel] += 1


def launch_counts() -> dict:
    """Every registered kernel's launches, by name."""
    with _count_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _count_lock:
        for kernel in _launches:
            _launches[kernel] = 0


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels of csrc/")
    return found


def library_path(source: Path) -> Path:
    """Where ``source``'s library lives."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


@profiling.spanned("ops.build")
def build_all(sources) -> dict:
    """Compile every source not yet built, one ``nvcc`` each, in parallel.
    Returns {source name: nvcc's report (registers, shared memory, spills),
    or "" when it was built already}. Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, logs = {}, {}
    for src in sources:
        out = library_path(src)
        if out.exists():
            logs[src.name] = ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[src.name] = (out, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name} ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    profiling.count("ops.builds.compiled", len(procs))
    profiling.count("ops.builds.cached", len(logs) - len(procs))
    return logs


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if need be."""
    with _load_lock:
        lib = _loaded.get(source)
        if lib is None:
            build_all([source])
            lib = ctypes.CDLL(str(library_path(source)))
            _loaded[source] = lib
        return lib


class Library:
    """``csrc/<source>``'s library, built and loaded at the first call.

    ``entry_points``: each C function's argument types; every entry point
    returns a CUDA error code (``check_launch``). ``kernels``: the names the
    module's wrappers count their launches under, registered at zero here.
    """

    def __init__(self, source: str, kernels, **entry_points):
        self.source = CSRC / source
        self._entry_points = entry_points
        self._lib = None
        with _count_lock:
            for kernel in kernels:
                _launches.setdefault(kernel, 0)

    def __call__(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = load(self.source)
            for name, argtypes in self._entry_points.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            self._lib = lib
        return self._lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (0 means launched)."""
    if err != 0:
        lib_err = lib.rgl_error_string
        lib_err.argtypes = [ctypes.c_int]
        lib_err.restype = ctypes.c_char_p
        raise RuntimeError(f"{what} launch failed: CUDA error {err}, "
                           f"{lib_err(err).decode()}")


def check_tensors(device, **tensors) -> None:
    """Raise unless every ``name=(tensor, dtype)`` is a contiguous CUDA
    tensor of that dtype on ``device``: what a kernel takes."""
    for name, (t, dtype) in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} is not on a CUDA device")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the kernel runs on "
                             f"{device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def check_smem(nbytes: int, what: str) -> None:
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(f"{what} needs {nbytes} B of shared memory a CTA; "
                         f"the card allows {MAX_SMEM_BYTES}")
