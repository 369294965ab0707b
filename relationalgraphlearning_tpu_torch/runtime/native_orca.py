"""ctypes bindings for the native batched ORCA library (port of
``relationalgraphlearning_tpu/runtime/native_orca.py``).

The native side is the repository's ``native/orca/orca.cpp`` (batched
multi-env C++ ORCA, the counterpart of the reference's RVO2 binding). The
port compiles it with ``g++`` at first use into its git-ignored
``_build/`` (the library's name hashes the source and the flags), and
never touches ``native/orca/`` itself. Without a compiler
``native_orca_available()`` is False, and a call raises.

``orca_step_batch_native`` steps host arrays; ``NativeORCA`` is the same
call on tensors, wherever they live: device → host, the C++ solver, host →
device (the reference's ``jax.pure_callback``). The on-device path stays
``envs/orca.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch.ops._build import BUILD_DIR

log = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parents[2] / "native" / "orca" / "orca.cpp"
# the Makefile's flags without OpenMP: a toolchain may accept -fopenmp and
# still lack libgomp to link it, and each env's solve is independent, so
# the serial build gives the same results
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"liborca_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """Compile ``orca.cpp`` once -> the library's path (None: no compiler
    or no source; the failure is logged)."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None or not SOURCE.exists():
        log.warning("native ORCA: no C++ compiler or no %s", SOURCE)
        return None
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        log.warning("native ORCA build failed:\n%s", proc.stderr)
        return None
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.orca_step_batch.argtypes = [
            f32p, f32p, f32p, f32p, f32p, u8p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            f32p]
        lib.orca_step_batch.restype = None
        lib.orca_version.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_orca_available() -> bool:
    return _load() is not None


def orca_step_batch_native(
        positions: np.ndarray, velocities: np.ndarray, radii: np.ndarray,
        pref_vels: np.ndarray, max_speeds: np.ndarray, active: np.ndarray,
        neighbor_dist: float = 10.0, time_horizon: float = 5.0,
        time_step: float = 0.25, safety_space: float = 0.0) -> np.ndarray:
    """positions/velocities/pref_vels [B, n, 2]; radii/max_speeds [B, n];
    active [B, n] → new velocities [B, n, 2]."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native ORCA library unavailable (no C++ "
                           "compiler, or its build failed)")
    positions = np.ascontiguousarray(positions, np.float32)
    velocities = np.ascontiguousarray(velocities, np.float32)
    radii = np.ascontiguousarray(radii, np.float32)
    pref_vels = np.ascontiguousarray(pref_vels, np.float32)
    max_speeds = np.ascontiguousarray(max_speeds, np.float32)
    active = np.ascontiguousarray(active, np.uint8)
    B, n = radii.shape
    out = np.empty((B, n, 2), np.float32)
    lib.orca_step_batch(
        positions, velocities, radii, pref_vels, max_speeds, active, B, n,
        neighbor_dist, time_horizon, time_step, safety_space, out)
    return out


class NativeORCA:
    """The C++ solver on tensors: device → host, the call, host → device
    (the reference's ``jax.pure_callback``). A host call, so never inside a
    captured CUDA graph."""

    def __init__(self, neighbor_dist=10.0, time_horizon=5.0, time_step=0.25,
                 safety_space=0.0):
        self.kw = dict(neighbor_dist=neighbor_dist, time_horizon=time_horizon,
                       time_step=time_step, safety_space=safety_space)

    def __call__(self, positions: Tensor, velocities: Tensor, radii: Tensor,
                 pref_vels: Tensor, max_speeds: Tensor, active: Tensor
                 ) -> Tensor:
        host = [t.detach().cpu().numpy() for t in (
            positions, velocities, radii, pref_vels, max_speeds)]
        out = orca_step_batch_native(
            *host, active.detach().cpu().numpy().astype(np.uint8), **self.kw)
        return torch.from_numpy(out).to(positions.device)
