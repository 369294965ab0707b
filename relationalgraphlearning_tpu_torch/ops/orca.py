"""ORCA's velocity solve as one CUDA kernel: the wrapper.

The kernel (``csrc/orca_velocity.cu``) solves every agent's ORCA problem in
one thread: its M half-planes, linearProgram1/2 and, where linearProgram2
fails, linearProgram3. The plain version is ``envs/orca.py::
orca_velocity_plain``, the masked tensor transcription of the JAX package's
solver; ``envs/orca.py::orca_velocity`` runs it for CPU tensors and this
wrapper for CUDA tensors. The kernel repeats the plain version's float32
arithmetic operation by operation, so on the card the two agree bit for
bit.

The wrapper takes what the plain version takes, with its broadcasting:
p_i/v_i/pref_vel [..., 2], r_i/max_speed [...], p_j/v_j [..., M, 2],
r_j/valid [..., M], 1 <= M <= 64, float32 (``valid`` bool), and reads each
operand through its strides, so an ``expand``ed neighbour table is not
copied. It raises on anything else; it never falls back.
Its launches count as ``orca_velocity`` (``_build.launch_counts``). The
kernel adds, on every launch and replay, the agents that took
linearProgram3 into a per-device int64 that ``utils/profiling.py`` reads in
a traced run as the counter ``orca.lp3_agents``. The agents solved need no
counter: a launch solves every agent of its leading shape.
"""

from __future__ import annotations

import ctypes
import itertools
import math
import threading

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch.ops import _build
from relationalgraphlearning_tpu_torch.utils import profiling

MAX_NEIGHBOURS = 64     # the largest instantiation in the source
LEAD_DIMS = 4           # kLead in the source
EPS = 1e-5              # envs/orca.py's _EPS, as the kernel compares with it
# the operands in the order the kernel takes them, and whether each has a
# neighbour dimension and an (x, y) one past its leading dimensions
_TRAILING = dict(p_i=(0, 1), v_i=(0, 1), r_i=(0, 0), pref_vel=(0, 1),
                 max_speed=(0, 0), p_j=(1, 1), v_j=(1, 1), r_j=(1, 0),
                 valid=(1, 0))
OPERANDS = tuple(_TRAILING)

_lib = _build.Library(
    "orca_velocity.cu", kernels=("orca_velocity",),
    orca_velocity_launch=[ctypes.c_void_p] * 3
    + [ctypes.c_int64, ctypes.c_int] + [ctypes.c_float] * 5
    + [ctypes.c_void_p] * 3)
_lp3: dict = {}         # device -> int64, the agents through LP3
_lp3_lock = threading.Lock()  # ranks run as threads launch at once


def _counter(device: torch.device) -> Tensor:
    """The device's int64 the kernel counts LP3's agents into, made (and
    handed to ``profiling``) at its first launch there."""
    with _lp3_lock:
        t = _lp3.get(device)
        if t is None:
            t = _lp3[device] = torch.zeros((), dtype=torch.int64,
                                           device=device)
            profiling.device_counter("orca.lp3_agents", t)
        return t


def _broadcast(shapes) -> tuple:
    """The shape ``shapes`` broadcast to, as ``torch.broadcast_shapes``
    gives it (which imports sympy, seconds of set-up, at its first call)."""
    out = []
    for sizes in itertools.zip_longest(*(reversed(s) for s in shapes),
                                       fillvalue=1):
        other = set(sizes) - {1}
        if len(other) > 1:
            raise ValueError(f"the ORCA operands do not broadcast: "
                             f"{[tuple(s) for s in shapes]}")
        out.append(other.pop() if other else 1)
    return tuple(reversed(out))


def operands(p_i: Tensor, v_i: Tensor, r_i: Tensor, pref_vel: Tensor,
             max_speed: Tensor, p_j: Tensor, v_j: Tensor, r_j: Tensor,
             valid: Tensor):
    """Check the operands and lay them out as the kernel reads them ->
    (operands broadcast to their full shapes, leading shape, M, the leading
    sizes and each operand's strides over LEAD_DIMS merged leading
    dimensions, the neighbour dimension and the component). Raises on a
    shape, a dtype or an M the kernel does not take."""
    ops = dict(zip(OPERANDS, (p_i, v_i, r_i, pref_vel, max_speed, p_j, v_j,
                              r_j, valid)))
    for name, t in ops.items():
        want = torch.bool if name == "valid" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}; the ORCA kernel takes "
                            f"{want}")
        if t.dim() < sum(_TRAILING[name]):
            raise ValueError(f"{name} has shape {tuple(t.shape)}: too few "
                             f"dimensions")
        if _TRAILING[name][1] and t.shape[-1] != 2:
            raise ValueError(f"{name} has shape {tuple(t.shape)}: its last "
                             f"dimension is not 2")
    lead = _broadcast([t.shape[:t.dim() - sum(_TRAILING[name])]
                       for name, t in ops.items()])
    (M,) = _broadcast([(t.shape[t.dim() - sum(_TRAILING[name])],)
                       for name, t in ops.items() if _TRAILING[name][0]])
    if not 1 <= M <= MAX_NEIGHBOURS:
        raise ValueError(f"{M} neighbours an agent; the ORCA kernel takes 1 "
                         f"to {MAX_NEIGHBOURS}")
    k = len(lead)
    ops = {name: t.expand((*lead, *((M,) if _TRAILING[name][0] else ()),
                           *((2,) if _TRAILING[name][1] else ())))
           for name, t in ops.items()}
    # the neighbour's and the component's strides, 0 where there is none
    inner = [[t.stride(k) if _TRAILING[name][0] else 0,
              t.stride(-1) if _TRAILING[name][1] else 0]
             for name, t in ops.items()]
    # leading dimensions that every operand steps through as one merge,
    # those of size 1 go
    sizes, strides = [], [[] for _ in ops]
    for d in range(k):
        if lead[d] == 1:
            continue
        step = [t.stride(d) for t in ops.values()]
        if sizes and all(st[-1] == s * lead[d]
                         for st, s in zip(strides, step)):
            sizes[-1] *= lead[d]
            for st, s in zip(strides, step):
                st[-1] = s
        else:
            sizes.append(lead[d])
            for st, s in zip(strides, step):
                st.append(s)
    if len(sizes) > LEAD_DIMS:
        raise ValueError(f"the ORCA operands' leading shape {tuple(lead)} "
                         f"does not merge into {LEAD_DIMS} dimensions")
    pad = LEAD_DIMS - len(sizes)
    sizes = [1] * pad + sizes
    strides = [[0] * pad + st + inn for st, inn in zip(strides, inner)]
    return ops, lead, M, sizes, strides


def orca_velocity(p_i: Tensor, v_i: Tensor, r_i: Tensor, pref_vel: Tensor,
                  max_speed: Tensor, p_j: Tensor, v_j: Tensor, r_j: Tensor,
                  valid: Tensor, params) -> Tensor:
    """New velocity of each agent given its M (masked) neighbours, one
    launch: the shapes of ``envs/orca.py::orca_velocity_plain`` → [..., 2].
    ``params``: an ``ORCAParams``."""
    ops, lead, M, sizes, strides = operands(
        p_i, v_i, r_i, pref_vel, max_speed, p_j, v_j, r_j, valid)
    device = p_i.device
    for name, t in ops.items():
        if not t.is_cuda:
            raise ValueError(f"{name} is not on a CUDA device (the plain "
                             f"version is envs/orca.py::orca_velocity_plain)")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, p_i on {device}")
    out = torch.empty((*lead, 2), dtype=torch.float32, device=device)
    n = math.prod(lead)
    if n == 0:
        return out
    lib = _lib()
    lp3 = _counter(device)
    ptrs = (ctypes.c_void_p * len(OPERANDS))(
        *(t.data_ptr() for t in ops.values()))
    flat = [s for st in strides for s in st]
    with torch.cuda.device(device):
        err = lib.orca_velocity_launch(
            ptrs, (ctypes.c_int64 * len(flat))(*flat),
            (ctypes.c_int64 * LEAD_DIMS)(*sizes), n, M,
            1.0 / params.time_horizon, 1.0 / params.time_step,
            params.neighbor_dist ** 2, params.safety_space, EPS,
            out.data_ptr(), lp3.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, f"orca_velocity (n={n}, M={M})")
    _build.count_launch("orca_velocity")
    return out
