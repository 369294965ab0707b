"""MP-RGL's value estimator as one CUDA kernel: the wrapper.

The kernel (``csrc/rgl_value.cu``) computes ``MPRLNetworks.value``'s
``value_network(RGL(robot, humans)[..., 0, :])`` for every forward of a
batched call in one launch: a block takes a tile of up to TEAMS
consecutive forwards, their dense layers as products over the tile and
their relation part four lanes a forward. The plain version is
``MPRLNetworks.value`` itself (``models/{rgl,mprl_networks}.py``); the
planner (``policies/model_predictive_rl.py::ModelPredictiveRLPolicy.value``)
runs it for CPU tensors and this wrapper for CUDA tensors, after the
networks' canonicalisation. Float32 throughout; sums are taken in another
order than the eager path's, so the two agree to float32 rounding.

It takes the MP-RGL graph every configuration of the port builds
(``check_networks``): ``embedded_gaussian``, ``layerwise_graph``, no skip
connection, 2 GCN layers, ``wr_dims``/``wh_dims`` (64, 32), 32-wide nodes,
value dims (32, 100, 100, 1), and 1 to ``MAX_HUMANS`` humans; robot
[..., 9] and humans [..., N, 5] float32 with the same leading shape, read
through their strides (an ``expand``ed humans tensor is not copied). It
raises on anything else, and in grad mode with parameters that need
gradients; it never falls back.

``plan`` reads the strides: consecutive forwards whose humans lie at one
address (a stride-0 leading dimension, as the planner's children view
their parent's predicted humans) form a group, whose humans the kernel
embeds once. Its launches count as ``rgl_value``
(``_build.launch_counts``); each launch also counts the profiling counters
``plan.value_kernel_forwards`` (forwards computed) and
``plan.value_shared_forwards`` (of those, forwards in groups of more than
one), at capture time as every launch count does.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch.ops import _build
from relationalgraphlearning_tpu_torch.utils import profiling

KERNEL = "rgl_value"
MAX_HUMANS = 16      # kMaxHumans in the source
TEAMS = 128          # kTeams: forwards a tile, four lanes each
STASH = 101          # kStash: a team's stash
LEAD_DIMS = 4        # kLead
WEIGHT_FLOATS = 23356  # kWeights: the staged weights, padded
NODE = 32            # kX: a node's features
ROW = 36             # kRow: a node's features, padded
ROBOT_DIM, HUMAN_DIM = 9, 5

# what the kernel is written for: the config's keys, then the parameters'
# shapes in the order the kernel takes them
GCN = dict(similarity_function="embedded_gaussian", layerwise_graph=True,
           skip_connection=False, num_layer=2, robot_state_dim=ROBOT_DIM,
           human_state_dim=HUMAN_DIM, wr_dims=(64, 32), wh_dims=(64, 32),
           gcn2_w1_dim=32, final_state_dim=32)
VALUE_DIMS = (32, 100, 100, 1)
SHAPES = ((64, 9), (64,), (32, 64), (32,), (64, 5), (64,), (32, 64), (32,),
          (32, 32), (32, 32), (32, 32), (32, 32), (32,), (100, 32), (100,),
          (100, 100), (100,), (1, 100), (1,))

_lib = _build.Library(
    "rgl_value.cu", kernels=(KERNEL,), rgl_value_prepare=[],
    rgl_value_launch=[ctypes.c_void_p] * 6)
_prepared: set = set()   # devices the kernel's attributes were set on
_prepare_lock = threading.Lock()


def group_floats(humans: int) -> int:
    """Shared floats of one group: its humans' rows of X, X·Wa^T, X·W1^T
    and their scores against each other (``group_floats`` in the source)."""
    return 3 * humans * ROW + (humans * humans + 3) // 4 * 4


def smem_bytes(humans: int, groups: int) -> int:
    """A block's shared memory with room for ``groups`` groups
    (``smem_floats`` in the source)."""
    return 4 * (WEIGHT_FLOATS + (2 * humans + 1 + STASH + 2 * NODE) * TEAMS
                + groups * group_floats(humans))


class Plan(NamedTuple):
    """How one call's forwards are laid out and tiled."""
    sizes: tuple            # LEAD_DIMS merged leading sizes, outermost first
    robot_strides: tuple    # the robot's strides over them
    human_strides: tuple    # the humans'; 0 along the group's dimensions
    n: int                  # forwards
    group_size: int         # consecutive forwards that share their humans
    groups: int
    tile: int               # forwards a tile (a block's pass)
    tiles: int
    max_groups: int         # groups a tile may touch
    smem_bytes: int


def plan(lead, robot_strides, human_strides, humans: int) -> Plan:
    """The layout and tiles of a call with leading shape ``lead`` and the
    robot's and the humans' strides over it: dimensions of size 1 go,
    neighbours that both operands step through as one merge; the trailing
    dimensions along which the humans' stride is 0 make a group (their
    product its size, 1 if there are none). A tile is TEAMS consecutive
    forwards, or fewer where the groups it may touch (and embed) would not
    fit in shared memory. Raises if the dimensions do not merge into
    LEAD_DIMS or ``humans`` is out of range."""
    if not 1 <= humans <= MAX_HUMANS:
        raise ValueError(f"{humans} humans a state; the RGL value kernel "
                         f"takes 1 to {MAX_HUMANS}")
    sizes, rs, hs = [], [], []
    for size, r, h in zip(lead, robot_strides, human_strides):
        if size == 1:
            continue
        if sizes and rs[-1] == r * size and hs[-1] == h * size:
            sizes[-1] *= size
            rs[-1], hs[-1] = r, h
        else:
            sizes.append(size)
            rs.append(r)
            hs.append(h)
    if len(sizes) > LEAD_DIMS:
        raise ValueError(f"the leading shape {tuple(lead)} does not merge "
                         f"into {LEAD_DIMS} dimensions")
    n = math.prod(sizes)
    group = 1
    for size, h in zip(reversed(sizes), reversed(hs)):
        if h != 0 or n == 0:
            break
        group *= size
    groups = n // group
    # a tile of T forwards touches at most ceil((T - 1) / group) + 1 groups
    room = (_build.MAX_SMEM_BYTES - smem_bytes(humans, 0)) \
        // (4 * group_floats(humans))
    tile = max(1, min(TEAMS, (room - 1) * group + 1, n))
    touched = min(-(-(tile - 1) // group) + 1, max(groups, 1))
    pad = LEAD_DIMS - len(sizes)
    return Plan(tuple([1] * pad + sizes), tuple([0] * pad + rs),
                tuple([0] * pad + hs), n, group, groups, tile,
                -(-n // tile), touched, smem_bytes(humans, touched))


def check_networks(networks) -> None:
    """Raise unless ``networks`` (an ``MPRLNetworks``) is the graph the
    kernel computes: its config and its value parameters' shapes."""
    gcn = networks.cfg.gcn
    for key, want in GCN.items():
        got = getattr(gcn, key)
        if (tuple(got) if isinstance(want, tuple) else got) != want:
            raise ValueError(f"the RGL value kernel takes gcn.{key} = "
                             f"{want!r}, not {got!r}")
    dims = tuple(networks.cfg.mprl.value_network_dims)
    if dims != VALUE_DIMS:
        raise ValueError(f"the RGL value kernel takes value_network_dims = "
                         f"{VALUE_DIMS}, not {dims}")
    for p, shape in zip(weights(networks), SHAPES):
        if tuple(p.shape) != shape:
            raise ValueError(f"a value parameter has shape "
                             f"{tuple(p.shape)}; the kernel takes {shape}")


def weights(networks) -> list:
    """The value estimator's parameters in the order the kernel takes
    them: w_r, w_h (weight, bias each layer), w_a, the two GCN layers, the
    value network (weight, bias each layer)."""
    g = networks.value_graph_model
    out = []
    for mlp in (g.w_r, g.w_h):
        for layer in mlp.layers:
            out += [layer.weight, layer.bias]
    out += [g.w_a.weight, g.gcn_layers[0].weight, g.gcn_layers[1].weight]
    for layer in networks.value_network.layers:
        out += [layer.weight, layer.bias]
    return out


def _prepare(device: torch.device):
    """The library, with the kernel's shared-memory limit raised on
    ``device`` (once, at its first launch there)."""
    lib = _lib()
    with _prepare_lock:
        if device not in _prepared:
            with torch.cuda.device(device):
                _build.check_launch(lib, lib.rgl_value_prepare(),
                                    "rgl_value_prepare")
            _prepared.add(device)
    return lib


def rgl_value(networks, robot: Tensor, humans: Tensor) -> Tensor:
    """V(s) [...] of robot [..., 9] and humans [..., N, 5] (CUDA, float32,
    already canonicalised where the config says so) under ``networks``'
    value estimator, one launch."""
    check_networks(networks)
    params = weights(networks)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (*params, robot, humans)):
        raise RuntimeError("the RGL value kernel computes no gradient: call "
                           "it under torch.no_grad() or with frozen "
                           "parameters (the eager path is "
                           "MPRLNetworks.value)")
    device = robot.device
    for name, t in (("robot", robot), ("humans", humans)):
        if not t.is_cuda:
            raise ValueError(f"{name} is not on a CUDA device (the plain "
                             f"version is MPRLNetworks.value)")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, robot on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the RGL value kernel "
                            f"takes torch.float32")
    _build.check_tensors(device, **{f"parameter {i}": (p, torch.float32)
                                    for i, p in enumerate(params)})
    for i, p in enumerate(params):
        if p.data_ptr() % 16:
            raise ValueError(f"parameter {i} is not 16-byte aligned (the "
                             f"kernel reads it as float4s)")
    if robot.dim() < 1 or robot.shape[-1] != ROBOT_DIM:
        raise ValueError(f"robot has shape {tuple(robot.shape)}; want "
                         f"[..., {ROBOT_DIM}]")
    if humans.dim() < 2 or humans.shape[-1] != HUMAN_DIM or \
            humans.shape[:-2] != robot.shape[:-1]:
        raise ValueError(f"humans has shape {tuple(humans.shape)}; want "
                         f"[{', '.join(map(str, robot.shape[:-1]))}"
                         f"{', ' if robot.dim() > 1 else ''}N, {HUMAN_DIM}]")
    lead = tuple(robot.shape[:-1])
    k = len(lead)
    p = plan(lead, robot.stride()[:k], humans.stride()[:k], humans.shape[-2])
    out = torch.empty(lead, dtype=torch.float32, device=device)
    if p.n == 0:
        return out
    lib = _prepare(device)
    layout = (*p.sizes, *p.robot_strides, *p.human_strides, robot.stride(-1),
              humans.stride(-2), humans.stride(-1), p.n, p.group_size,
              p.tile, p.tiles, p.max_groups, humans.shape[-2])
    with torch.cuda.device(device):
        err = lib.rgl_value_launch(
            (ctypes.c_void_p * len(params))(*(t.data_ptr() for t in params)),
            robot.data_ptr(), humans.data_ptr(),
            (ctypes.c_int64 * len(layout))(*layout), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, err, f"rgl_value (n={p.n}, group "
                                  f"{p.group_size}, N={humans.shape[-2]})")
    _build.count_launch(KERNEL)
    profiling.count("plan.value_kernel_forwards", p.n)
    profiling.count("plan.value_shared_forwards",
                    p.n if p.group_size > 1 else 0)
    return out
