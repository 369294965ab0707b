"""The port's ranks and collectives (``parallel/comm.py``), its mesh and its
multi-process entry points, held to their definitions.

``LocalComm`` runs D ranks as threads of one process (the counterpart of the
JAX package's virtual 8-device CPU mesh); ``DistComm`` runs them as
``torch.distributed`` processes over gloo, which must give the same bits on
the same per-rank function (atol = 0). Every wait here has a timeout: a rank
that fails ends the run, it never hangs it.
"""

import sys
import threading
import time

import pytest
import torch
from torch.utils._pytree import tree_leaves

from relationalgraphlearning_tpu_torch.parallel import comm as pcomm
from relationalgraphlearning_tpu_torch.parallel import distributed
from relationalgraphlearning_tpu_torch.parallel.graph_partition import (
    halo_exchange)
from relationalgraphlearning_tpu_torch.parallel.mesh import (
    REP, ROW, make_mesh, split_rows)


def _rows(n=8, d=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, d, generator=g)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_local_comm_collectives_match_their_definitions(D):
    x = _rows(4 * D)
    out = make_mesh(data=D, device="cpu").run(pcomm.collectives,
                                              row_sharded=(x,))
    parts = split_rows(x, D)
    m = 4
    for r in range(D):
        rows = slice(r * m, (r + 1) * m)
        assert int(out["rank"][r]) == r and int(out["size"][r]) == D
        # ppermute(+1): rank r holds rank r-1's block; the ring wraps
        torch.testing.assert_close(out["next"][rows], parts[(r - 1) % D],
                                   rtol=0, atol=0)
        torch.testing.assert_close(out["prev"][rows], parts[(r + 1) % D],
                                   rtol=0, atol=0)
        torch.testing.assert_close(out["pair"][0][rows], parts[(r - 1) % D],
                                   rtol=0, atol=0)
        assert torch.equal(out["pair"][1][rows], parts[(r - 1) % D] > 0)
        want = parts[0]
        for p in parts[1:]:
            want = want + p                 # rank order
        torch.testing.assert_close(out["psum"][rows], want, rtol=0, atol=0)
        torch.testing.assert_close(out["pmean"][rows], want / D, rtol=0,
                                   atol=0)
        assert int(out["count"][r]) == int((x > 0).sum())
        torch.testing.assert_close(out["all_gather"][r * 4 * D:
                                                     (r + 1) * 4 * D], x,
                                   rtol=0, atol=0)


def _fail_on_rank_1(comm):
    if comm.rank == 1:
        raise ValueError("rank 1 fails")
    return comm.psum(torch.ones(1))


def test_a_rank_that_raises_makes_every_rank_raise():
    t = time.monotonic()
    with pytest.raises(ValueError, match="rank 1 fails"):
        pcomm.run_local(4, _fail_on_rank_1, timeout=60.0)
    assert time.monotonic() - t < 10.0      # the barrier broke, no wait


def test_a_rank_that_skips_a_collective_times_out():
    def skip_on_rank_0(comm):
        if comm.rank == 0:
            return None
        return comm.psum(torch.ones(1))

    t = time.monotonic()
    with pytest.raises(TimeoutError):
        pcomm.run_local(3, skip_on_rank_0, timeout=1.0)
    assert time.monotonic() - t < 10.0


def test_local_comm_stress_keeps_every_round():
    """More ranks than cores, a short switch interval and many rounds: a
    rank that deposited before its peers read would break the sums."""
    D, rounds = 16, 50

    def body(comm):
        out = []
        for i in range(rounds):
            v = torch.tensor([float(comm.rank * rounds + i)])
            out.append(comm.psum(v))
            out.append(comm.all_gather(v))
        return out

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        res = pcomm.run_local(D, body, timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    for i in range(rounds):
        want = torch.tensor([float(r * rounds + i) for r in range(D)])
        for r in range(D):
            assert float(res[r][2 * i]) == float(want.sum())
            assert torch.equal(res[r][2 * i + 1], want)


def test_grad_mode_follows_the_caller():
    def body(comm):
        return torch.tensor([float(torch.is_grad_enabled())])

    with torch.no_grad():
        assert float(make_mesh(data=2, device="cpu").run(body)[0]) == 0.0
    with torch.enable_grad():
        assert float(make_mesh(data=2, device="cpu").run(body)[0]) == 1.0


@pytest.mark.parametrize("D", [2, 4])
def test_dist_comm_over_gloo_equals_local_comm(D):
    x = _rows(4 * D, seed=D)
    local = make_mesh(data=D, device="cpu").run(pcomm.collectives,
                                                row_sharded=(x,))
    procs = distributed.launch(pcomm.collectives, D, row_sharded=(x,),
                               device="cpu", timeout=120.0)
    _equal(procs, local)


def test_a_failing_process_raises_its_traceback():
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="halo_exchange needs halo > 0"):
        distributed.launch(halo_exchange, 2, replicated=(torch.zeros(4, 1),
                                                         0), device="cpu",
                           timeout=120.0)
    assert time.monotonic() - t < 60.0


def test_launch_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    # with no device named the ranks run on the card; with no card the
    # launch raises before it spawns anything, it never drops to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.launch(pcomm.collectives, 2, row_sharded=(_rows(8),))


def test_distributed_single_process_fallback(monkeypatch):
    for var in ("JAX_COORDINATOR", "NPROC", "PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert distributed.initialize(num_processes=1) is False
    assert distributed.initialize("localhost:1", num_processes=1) is False
    assert distributed.is_primary()


def test_make_mesh_counts_as_the_reference():
    assert make_mesh(device="cpu").shape == {"data": 8, "model": 1}
    assert make_mesh(model=2, device="cpu").shape == {"data": 4, "model": 2}
    assert make_mesh(data=4, model=2, device="cpu").shape == {"data": 4,
                                                              "model": 2}
    assert make_mesh(data=3, device="cpu").data == 3   # a prefix
    with pytest.raises(ValueError, match="mesh 9x1 > 8"):
        make_mesh(data=9, device="cpu")
    with pytest.raises(ValueError, match="mesh 4x4 > 8"):
        make_mesh(data=4, model=4, device="cpu")


def test_mesh_run_splits_rows_and_combines_by_spec():
    x = _rows(6)

    def body(comm, scale, rows):
        return rows * scale, torch.tensor([comm.rank]), {"n": rows[:1]}

    mesh = make_mesh(data=3, device="cpu")
    rows, rank, d = mesh.run(body, replicated=(2.0,), row_sharded=(x,),
                             out_specs=(ROW, REP, {"n": ROW}))
    torch.testing.assert_close(rows, 2.0 * x, rtol=0, atol=0)
    assert int(rank) == 0
    torch.testing.assert_close(d["n"], x[::2], rtol=0, atol=0)
    with pytest.raises(ValueError, match="do not split over 4 ranks"):
        make_mesh(data=4, device="cpu").run(body, (1.0,), (x,))


def test_run_local_leaves_no_rank_running():
    before = {t.name for t in threading.enumerate()}
    make_mesh(data=4, device="cpu").run(pcomm.collectives,
                                        row_sharded=(_rows(8),))
    after = {t.name for t in threading.enumerate() if t.is_alive()}
    assert not {f"rank{r}" for r in range(4)} & (after - before)
