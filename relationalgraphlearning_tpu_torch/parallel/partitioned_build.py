"""Distributed graph construction and the partitioned mega-crowd rollout.

Port of ``relationalgraphlearning_tpu/parallel/partitioned_build.py``. The
whole amortised rollout (band partition, migration, spatial sort, kNN,
candidate windows, bitpacked masks, ORCA, block-RGL values) runs per rank
with fixed shapes and only ring-neighbour ``ppermute``s and ``psum``s:

- **Band partition.** Space splits into D bands along x; rank s owns a
  slab of ``n_cap`` agent slots (``active`` marks the used ones) for the
  agents in band s. Global node id = rank·n_cap + slot, the layout
  ``block_halo_attention`` assumes.
- **Migration** (each rebuild): agents whose x crossed a band edge move to
  the adjacent rank through two fixed-capacity buffers; ``overflow`` and
  ``lost`` count what did not fit.
- **Local sort and build** (each rebuild): each rank sorts its slab by the
  GLOBAL grid-cell key (actives first), exchanges the full adjacent slabs
  and builds exact kNN, block windows (global ids, sentinel D·n_cap) and
  packed masks over the 3·n_cap-row extended table, with two coverage
  checks: ``band_cov`` (agents whose k-th neighbour lies inside the
  adjacent-band reach) and ``win_cov`` (windows hold every edge).
- **Step** (R a rebuild): exchange the adjacent slabs' positions and
  velocities, ORCA against the kNN columns, integrate, and the value net
  through ``block_halo_attention`` with ``halo = n_cap`` and kernel #1 on
  the packed masks.

Two faults of the reference are fixed here (the tests show both readings):
an active agent with fewer than K valid neighbours in reach, while the
crowd has more than K agents, counts as not covered (the reference reads
its k-th radius as 0, so covered); and the value net adds the skip
connection when ``cfg.skip_connection`` asks for it, as ``SparseRGL``
does (the reference's full-slab value net leaves it out).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor
from torch.utils._pytree import tree_map

from relationalgraphlearning_tpu_torch.envs.orca import (
    ORCAParams, centralized_orca_step_knn, orca_velocity)
from relationalgraphlearning_tpu_torch.models.sparse_rgl import SparseValueNet
from relationalgraphlearning_tpu_torch.ops import block_graph
from relationalgraphlearning_tpu_torch.ops.fused_block import pack_emask
from relationalgraphlearning_tpu_torch.ops.sparse import (
    _smallest_k, knn_graph, knn_graph_grid)
from relationalgraphlearning_tpu_torch.parallel.graph_partition import (
    block_halo_attention, halo_exchange)
from relationalgraphlearning_tpu_torch.parallel.mesh import REP, ROW, Mesh

_BIGKEY = 2 ** 30


class CrowdShards(NamedTuple):
    """Per-agent state in the banded slab layout, [D·n_cap, ...] rows split
    over the ranks. ``aid`` is the agent's original id (-1 in empty slots):
    identity survives migration and sorting."""

    pos: Tensor     # [n, 2]
    vel: Tensor     # [n, 2]
    goal: Tensor    # [n, 2]
    rad: Tensor     # [n]
    vmax: Tensor    # [n]
    active: Tensor  # [n] bool
    aid: Tensor     # [n] int32


@dataclasses.dataclass(frozen=True)
class BandSpec:
    """The partition's geometry. Rank s owns x ∈ [x0 + s·band_w, x0 +
    (s+1)·band_w). The cell raster (``cell``, ``grid_w``) is GLOBAL, so
    the ranks' sorts agree with a global sort; ``grid_w`` must exceed the
    domain's height in cells."""

    D: int          # ranks
    n_cap: int      # slots a rank (a multiple of B)
    x0: float
    band_w: float
    y0: float
    cell: float     # sort/grid cell size
    grid_w: int     # cell-key row stride
    B: int          # block rows
    C: int          # candidate window
    K: int          # kNN degree built (>= both consumers)
    K_orca: int     # ORCA's neighbours (the first K_orca of the K)
    mig_cap: int    # migration buffer slots a direction
    dt: float = 0.25
    # spatial-hash kNN inside the extended table instead of the dense
    # distance matrix (exact when cell ≥ the k-th-neighbour distance and no
    # cell holds more than grid_max_per_cell agents)
    grid_knn: bool = False
    grid_max_per_cell: int = 32


def init_crowd_shards(pos, vel, goal, rad, vmax, spec: BandSpec,
                      device="cuda") -> CrowdShards:
    """Host-side set-up: place n agents into the banded slab layout.

    Raises if any band holds more than ``n_cap`` agents (size the capacity
    with slack; migration keeps it balanced only up to crowd drift)."""
    pos = np.asarray(pos, np.float32)
    n = pos.shape[0]
    band = np.clip(((pos[:, 0] - spec.x0) // spec.band_w).astype(np.int64),
                   0, spec.D - 1)
    counts = np.bincount(band, minlength=spec.D)
    if counts.max() > spec.n_cap:
        raise ValueError(
            f"band occupancy {counts.max()} > n_cap={spec.n_cap}; "
            f"counts={counts.tolist()}")
    rows = spec.D * spec.n_cap
    out = {
        "pos": np.zeros((rows, 2), np.float32),
        "vel": np.zeros((rows, 2), np.float32),
        "goal": np.zeros((rows, 2), np.float32),
        "rad": np.zeros((rows,), np.float32),
        "vmax": np.zeros((rows,), np.float32),
        "active": np.zeros((rows,), bool),
        "aid": np.full((rows,), -1, np.int32),
    }
    src = {"pos": pos, "vel": np.asarray(vel), "goal": np.asarray(goal),
           "rad": np.asarray(rad), "vmax": np.asarray(vmax),
           "aid": np.arange(n, dtype=np.int32)}
    for s in range(spec.D):
        sel = np.nonzero(band == s)[0]
        sl = slice(s * spec.n_cap, s * spec.n_cap + len(sel))
        for k, v in src.items():
            out[k][sl] = v[sel]
        out["active"][sl] = True
    return CrowdShards(**{k: torch.from_numpy(v).to(device)
                          for k, v in out.items()})


# ----------------------------------------------------------- per-rank steps
def _stable_argsort(b: Tensor) -> Tensor:
    """``jnp.argsort`` of a bool array: stable, False first."""
    return torch.argsort(b.to(torch.int8), stable=True)


def _dest_band(x: Tensor, spec: BandSpec) -> Tensor:
    return torch.clamp(((x - spec.x0) // spec.band_w).to(torch.int32),
                       0, spec.D - 1)


def _migrate(comm, sh: CrowdShards, spec: BandSpec):
    """Adjacent-band migration through two fixed-capacity buffers.

    Returns (shards', stats): ``overflow`` counts agents that wanted to
    move but did not fit the buffer (they stay, and band coverage says
    so), ``lost`` received agents with no free slot (deactivated; must be
    0)."""
    me = comm.rank
    M = spec.mig_cap
    dest = torch.where(sh.active, _dest_band(sh.pos[:, 0], spec), me)

    def send(dirn: int):
        want = sh.active & (dest == me + dirn)
        take = _stable_argsort(~want)[:M]       # senders first
        took = want[take]                       # True for real migrants
        overflow = want.sum() - took.sum()
        sent = torch.zeros_like(want).index_put((take,), took)
        # the ring wraps, the bands do not: dest is clipped to [0, D-1], so
        # an edge rank never sends outward and receives nothing valid
        buf, rvalid = comm.ppermute(
            (CrowdShards(*(a[take] for a in sh)), took), dirn)
        return buf, rvalid, sent, overflow

    buf_l, rv_l, sent_l, ov_l = send(-1)
    buf_r, rv_r, sent_r, ov_r = send(+1)
    active = sh.active & ~sent_l & ~sent_r

    # merge the ≤ 2M received rows into free slots (valid first)
    buf = tree_map(lambda a, b: torch.cat([a, b]), buf_l, buf_r)
    rvalid = torch.cat([rv_l, rv_r])
    ordv = _stable_argsort(~rvalid)
    buf = tree_map(lambda a: a[ordv], buf)
    rvalid = rvalid[ordv]
    slot = _stable_argsort(active)[:2 * M]      # free slots first
    ok = rvalid & (torch.arange(2 * M, device=rvalid.device)
                   < (~active).sum())
    lost = rvalid.sum() - ok.sum()

    def place(cur: Tensor, new: Tensor) -> Tensor:
        okb = ok.reshape((-1,) + (1,) * (new.ndim - 1))
        return cur.index_put((slot,), torch.where(okb, new, cur[slot]))

    merged = CrowdShards(*(place(c, b) for c, b in zip(sh, buf)))
    active = active | torch.zeros_like(active).index_put((slot,), ok)
    return merged._replace(active=active), {"overflow": ov_l + ov_r,
                                            "lost": lost}


def _local_sort(sh: CrowdShards, spec: BandSpec) -> CrowdShards:
    """Sort the slab by the GLOBAL grid-cell key (actives first): the
    row-major raster of ``block_graph.spatial_sort``, so the ranks' orders
    concatenated are a global spatial order."""
    # the origin as a fill, not a host copy: a rank runs inside a capture
    origin = torch.stack([sh.pos.new_full((), spec.x0),
                          sh.pos.new_full((), spec.y0)])
    ij = torch.floor((sh.pos - origin) / spec.cell).to(torch.int32)
    key = ij[:, 0] * spec.grid_w + ij[:, 1]
    key = torch.where(sh.active, key, _BIGKEY)
    order = torch.argsort(key, stable=True)
    return CrowdShards(*(a[order] for a in sh))


def _build_graph(comm, sh: CrowdShards, spec: BandSpec):
    """Per-rank kNN, block windows and packed masks over the extended
    (3·n_cap) table; returns the coverage diagnostics as tensors."""
    me = comm.rank
    n_cap, K = spec.n_cap, spec.K
    dev = sh.pos.device
    pos_ext, act_ext, rad_ext, vmax_ext = halo_exchange(
        comm, (sh.pos, sh.active, sh.rad, sh.vmax), n_cap)
    strip_ok = torch.cat([
        torch.full((n_cap,), me > 0, device=dev),
        torch.ones((n_cap,), dtype=torch.bool, device=dev),
        torch.full((n_cap,), me < spec.D - 1, device=dev)])  # no wrap
    act_ext = act_ext & strip_ok
    me_ext = n_cap + torch.arange(n_cap, device=dev)

    if spec.grid_knn:
        # inactive slots sit at (0, 0) and would crowd the origin's cell:
        # park them in one far (bounded) corner cell; ``valid`` keeps them
        # out of every neighbour list
        far = torch.where(act_ext[:, None], pos_ext,
                          -torch.inf).amax(0) + 10.0 * spec.cell
        posg = torch.where(act_ext[:, None], pos_ext, far)
        eidx = knn_graph_grid(posg, K, spec.cell,
                              max_per_cell=spec.grid_max_per_cell,
                              valid=act_ext)[n_cap:2 * n_cap]
        d2k = ((sh.pos[:, None, :] - pos_ext[eidx]) ** 2).sum(-1)
        colvalid = (act_ext[eidx] & (eidx != me_ext[:, None])
                    & sh.active[:, None])
        negd = torch.where(colvalid, -d2k, -torch.inf)
    else:
        d2 = ((sh.pos[:, None, :] - pos_ext[None, :, :]) ** 2).sum(-1)
        d2 = d2.masked_fill(~act_ext[None, :], torch.inf)
        is_self = (torch.arange(3 * n_cap, device=dev)[None, :]
                   == me_ext[:, None])
        d2 = d2.masked_fill(is_self, torch.inf)
        eidx = _smallest_k(d2, K)                 # ascending, ties by index
        negd = -torch.gather(d2, 1, eidx)
        colvalid = torch.isfinite(negd) & sh.active[:, None]

    own_gid = me * n_cap + torch.arange(n_cap, device=dev)
    gid = (me - 1) * n_cap + eidx                 # extended id → global id
    cols = torch.where(colvalid, gid, own_gid[:, None])

    # band-reach coverage: the k-th neighbour's radius must fit inside the
    # extended region, else a true neighbour could hide two bands away
    kth = torch.sqrt(torch.where(colvalid[:, -1], -negd[:, -1], 0.0))
    f32 = dict(dtype=torch.float32, device=dev)
    lo = (torch.full((), -torch.inf, **f32) if me == 0 else
          torch.full((), me - 1, **f32) * spec.band_w + spec.x0)
    hi = (torch.full((), torch.inf, **f32) if me == spec.D - 1 else
          torch.full((), me + 2, **f32) * spec.band_w + spec.x0)
    margin = torch.minimum(sh.pos[:, 0] - lo, hi - sh.pos[:, 0])
    n_act = comm.psum(sh.active.sum())
    # fewer than K neighbours in reach while the crowd has more than K
    # agents: a true neighbour lies out of reach (the reference counts such
    # an agent as covered, its k-th radius read as 0)
    short = ~colvalid[:, -1] & (n_act > K)
    okb = ((kth <= margin) & ~short) | ~sh.active
    band_cov = comm.psum((sh.active & okb).sum()) / torch.clamp(n_act, min=1)

    cand, win_cov = block_graph.block_window(cols, spec.B, spec.C,
                                             sentinel=spec.D * n_cap)
    mbits = pack_emask(block_graph.block_masks(cols, cand, mask=colvalid))
    win_cov = comm.pmean(win_cov)
    return (eidx, colvalid, cand, mbits, rad_ext, vmax_ext, act_ext,
            band_cov, win_cov)


def _orca_step(pos, vel, sh: CrowdShards, eidx, colvalid, pos_ext, vel_ext,
               rad_ext, params: ORCAParams, K_orca: int) -> Tensor:
    """Masked-LP ORCA for the local slab against the extended table, all
    agents at once (``orca_velocity`` takes leading batch dimensions)."""
    idx = eidx[:, :K_orca]
    to = sh.goal - pos
    d = torch.linalg.norm(to, dim=-1, keepdim=True)
    pref = torch.where(d > 1e-3, to / torch.clamp(d, min=1e-9), 0.0)
    new_v = orca_velocity(pos, vel, sh.rad, pref, sh.vmax, pos_ext[idx],
                          vel_ext[idx], rad_ext[idx], colvalid[:, :K_orca],
                          params)
    return torch.where(sh.active[:, None], new_v, 0.0)


def _value_net_fullshard(comm, net: SparseValueNet, states: Tensor,
                         cand: Tensor, mbits: Tensor) -> Tensor:
    """``SparseValueNet`` with the aggregation through the full-adjacent
    slab halo (halo = n_cap): two ``ppermute``s of the slab a layer."""
    gm = net.graph_model
    n_cap = states.shape[0]
    H = gm.w_h(states)
    for layer in gm.gcn_layers:
        q = gm.w_a(H)
        out = block_halo_attention(comm, q, H, H, cand, mbits, halo=n_cap)
        H_next = torch.relu(layer(out))
        if gm.cfg.skip_connection and H_next.shape == H.shape:
            H_next = H_next + H
        H = H_next
    return net.value_network(H)[..., 0]


# ------------------------------------------------------------- the rollout
def mega_rollout_rank(comm, spec: BandSpec, net: SparseValueNet,
                      orca_params: ORCAParams, steps: int,
                      rebuild_every: int, sh: CrowdShards):
    """Per rank: ``steps // rebuild_every`` chunks of one rebuild and R
    steps. Returns (shards', per-chunk diagnostics [chunks] each)."""
    comm = comm.axis("data")  # a model axis replicates the rollout
    diags = []
    for _ in range(steps // rebuild_every):
        sh, mig = _migrate(comm, sh, spec)
        sh = _local_sort(sh, spec)
        (eidx, colvalid, cand, mbits, rad_ext, _, _, band_cov,
         win_cov) = _build_graph(comm, sh, spec)
        n_act = torch.clamp(comm.psum(sh.active.sum()), min=1)
        pos, vel = sh.pos, sh.vel
        vmeans = []
        for _ in range(rebuild_every):
            pos_ext, vel_ext = halo_exchange(comm, (pos, vel), spec.n_cap)
            vel = _orca_step(pos, vel, sh, eidx, colvalid, pos_ext, vel_ext,
                             rad_ext, orca_params, spec.K_orca)
            pos = pos + vel * spec.dt
            states = torch.cat([pos, vel, sh.rad[:, None]], dim=-1)
            vals = _value_net_fullshard(comm, net, states, cand, mbits)
            vmeans.append(comm.psum(torch.where(sh.active, vals, 0.0).sum())
                          / n_act)
        sh = sh._replace(pos=pos, vel=vel)
        diags.append({"band_cov": band_cov, "win_cov": win_cov,
                      "overflow": comm.psum(mig["overflow"]),
                      "lost": comm.psum(mig["lost"]),
                      "vmean": torch.stack(vmeans).mean()})
    return sh, {k: torch.stack([d[k] for d in diags]) for k in diags[0]}


def partitioned_mega_rollout(mesh: Mesh, spec: BandSpec, net: SparseValueNet,
                             orca_params: ORCAParams, steps: int,
                             rebuild_every: int, graphed: bool = False):
    """The partitioned mega-crowd rollout on ``mesh``'s data axis (D =
    ``spec.D`` ranks). ``net`` is a ``SparseValueNet`` (block semantics,
    whatever its backend). Returns ``run(shards) -> (shards', diag)``:
    ``diag`` holds the minimum band and window coverage over the chunks,
    the migration's total ``overflow`` and ``lost``, and the mean value.

    ``graphed``: the whole rollout of every rank, each chunk's rebuild
    included (nothing in it waits on the host), is captured at the first
    call as one CUDA graph (``Mesh.capture``, the reference's one
    ``shard_map`` program) and replayed after; ``run.graph`` holds it
    (its ``launches``). False: the ranks run eagerly."""
    if steps % rebuild_every:
        raise ValueError(f"steps={steps} is not a multiple of "
                         f"rebuild_every={rebuild_every}")
    if mesh.data != spec.D:
        raise ValueError(f"mesh of {mesh.data} ranks for D={spec.D} bands")

    def rank(comm, s):
        return mega_rollout_rank(comm, spec, net, orca_params, steps,
                                 rebuild_every, s)

    @torch.no_grad()
    def run(sh: CrowdShards):
        if not graphed:
            sh, diags = mesh.run(rank, row_sharded=(sh,),
                                 out_specs=(ROW, REP))
        else:
            if run.graph is None:
                run.graph = mesh.capture(rank, row_sharded=(sh,),
                                         out_specs=(ROW, REP))
            sh, diags = tree_map(torch.clone, run.graph(sh))
        return sh, {"band_cov": diags["band_cov"].amin(),
                    "win_cov": diags["win_cov"].amin(),
                    "overflow": diags["overflow"].sum(),
                    "lost": diags["lost"].sum(),
                    "vmean": diags["vmean"].mean()}

    run.graph = None
    return run


@torch.no_grad()
def single_device_rollout(net: SparseValueNet, pos: Tensor, vel: Tensor,
                          goals: Tensor, rad: Tensor, vmax: Tensor,
                          orca_params: ORCAParams, steps: int,
                          rebuild_every: int, K: int, K_orca: int,
                          dt: float = 0.25):
    """The global one-device program with the partitioned rollout's chunk
    semantics, its exactness reference (``tests/test_partitioned_build.py``
    of the JAX package): exact dense kNN at each chunk start, ORCA against
    the chunk's neighbour lists, the value net on the kNN graph each step.
    Returns (pos, vel, mean value)."""
    act = torch.ones(pos.shape[:1], dtype=torch.bool, device=pos.device)
    vmeans = []
    for _ in range(steps // rebuild_every):
        cols = knn_graph(pos, K)
        means = []
        for _ in range(rebuild_every):
            to = goals - pos
            d = torch.linalg.norm(to, dim=-1, keepdim=True)
            pref = torch.where(d > 1e-3, to / torch.clamp(d, min=1e-9), 0.0)
            vel = centralized_orca_step_knn(pos, vel, rad, pref, vmax, act,
                                            orca_params, K_orca,
                                            cols=cols[:, :K_orca])
            pos = pos + vel * dt
            states = torch.cat([pos, vel, rad[:, None]], dim=-1)
            means.append(net(states, cols).mean())
        vmeans.append(torch.stack(means).mean())
    return pos, vel, torch.stack(vmeans).mean()
