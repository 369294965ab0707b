"""The mesh's two axes (``parallel/mesh.py``, ``parallel/comm.py``): a
(data, model) mesh of rank threads, rank ``d * model + m`` at (d, m), as
the reference reshapes its devices, with each rank's ``comm.axis("data")``
and ``comm.axis("model")`` sub-groups (their own barrier and slots).

- Collectives over an axis add (concatenate) in the axis's rank order, so
  every rank of the axis holds the same bits (atol 0 against the sums made
  in that order).
- A rank that raises while its peers wait at an axis collective ends the
  whole run at once.
- ``Mesh.run`` on two axes: data slices shared by a data row, outputs of
  the model-rank-0 ranks in data order.
- ``make_mesh``'s errors are the reference's; ``Mesh.capture`` needs the
  card; a step over a ``DistComm`` (processes, gloo) is eager and asking
  for its graph raises.
"""

import functools
import operator
import time

import pytest
import torch

from relationalgraphlearning_tpu.parallel.mesh import make_mesh as jmesh
from relationalgraphlearning_tpu_torch.parallel import comm as pcomm
from relationalgraphlearning_tpu_torch.parallel.mesh import REP, make_mesh


def _rank_values(comm):
    g = torch.Generator().manual_seed(100 + comm.rank)
    return torch.randn(3, 5, generator=g) * 10.0 ** (comm.rank % 4)


def _axes(comm):
    x = _rank_values(comm)
    data, model = comm.axis("data"), comm.axis("model")
    return {"rank": torch.tensor([comm.rank, data.rank, data.size,
                                  model.rank, model.size]),
            "x": x[None],
            "psum_data": data.psum(x)[None],
            "psum_model": model.psum(x)[None],
            "gather_data": data.all_gather(x)[None],
            "gather_model_cols": model.all_gather(x, dim=-1)[None],
            "next_data": data.ppermute(x, +1)[None]}


@pytest.mark.parametrize("data, model", [(4, 2), (2, 2), (1, 4), (8, 1)])
def test_axis_groups_reduce_in_rank_order(data, model):
    size = data * model
    outs = pcomm.run_local(size, _axes, shape=(("data", data),
                                               ("model", model)))
    xs = [o["x"][0] for o in outs]
    for r, o in enumerate(outs):
        d, m = divmod(r, model)
        assert o["rank"].tolist() == [r, d, data, m, model]
        col = [xs[e * model + m] for e in range(data)]       # data axis
        row = [xs[d * model + j] for j in range(model)]      # model axis
        assert torch.equal(o["psum_data"][0],
                           functools.reduce(operator.add, col))
        assert torch.equal(o["psum_model"][0],
                           functools.reduce(operator.add, row))
        assert torch.equal(o["gather_data"][0], torch.cat(col))
        assert torch.equal(o["gather_model_cols"][0], torch.cat(row, -1))
        assert torch.equal(o["next_data"][0], col[(d - 1) % data])
    # every rank of an axis holds the same bits
    for r, o in enumerate(outs):
        d, m = divmod(r, model)
        assert torch.equal(o["psum_data"], outs[m]["psum_data"])
        assert torch.equal(o["psum_model"], outs[d * model]["psum_model"])


def _fail_in_a_model_group(comm):
    if comm.rank == 5:
        time.sleep(0.2)
        raise ValueError("rank 5 fails")
    comm.axis("model").psum(torch.ones(2))
    return comm.axis("data").psum(torch.ones(2))


def test_a_failing_rank_aborts_the_axis_groups():
    t = time.monotonic()
    with pytest.raises(ValueError, match="rank 5 fails"):
        pcomm.run_local(8, _fail_in_a_model_group, timeout=60.0,
                        shape=(("data", 4), ("model", 2)))
    assert time.monotonic() - t < 10.0


def test_a_one_axis_run_has_only_its_axis():
    def fn(comm):
        assert comm.axis("data") is comm
        with pytest.raises(ValueError, match="no axis 'model'"):
            comm.axis("model")
        return torch.zeros(1)
    pcomm.run_local(2, fn)


def test_mesh_run_on_two_axes_shares_rows_along_model():
    mesh = make_mesh(data=2, model=2, device="cpu")
    x = torch.arange(8.0).reshape(4, 2)

    def fn(comm, scale, rows):
        m = comm.axis("model").rank
        return rows * scale + 100 * m, comm.axis("model").psum(rows)

    got, summed = mesh.run(fn, replicated=(2.0,), row_sharded=(x,))
    assert torch.equal(got, x * 2.0)        # model rank 0's, in data order
    assert torch.equal(summed, x * 2)       # each row seen by both columns
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4
    rep = mesh.run(lambda comm: torch.tensor([comm.rank]), out_specs=REP)
    assert rep.tolist() == [0]


@pytest.mark.parametrize("data, model", [(8, 2), (3, 3), (5, 2)])
def test_make_mesh_errors_are_the_references(data, model):
    with pytest.raises(ValueError) as want:
        jmesh(data=data, model=model)
    with pytest.raises(ValueError) as got:
        make_mesh(data=data, model=model, device="cpu")
    assert str(got.value) == str(want.value)
    assert make_mesh(model=2, device="cpu").shape == dict(
        jmesh(model=2).shape)


def test_capture_needs_the_card():
    with pytest.raises(ValueError, match="on the card"):
        make_mesh(2, device="cpu").capture(lambda comm: None)


def test_a_dist_comm_step_is_eager_and_refuses_a_graph(tmp_path):
    """One gloo process: ``DistComm`` as the data axis (its model axis one
    rank). Its step equals the one-device step; a graph raises."""
    import torch.distributed as dist

    from test_torch_sharding import _batch, _step_setup, _torch_batch
    from relationalgraphlearning_tpu_torch.parallel import sharding

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 's'}",
                            rank=0, world_size=1)
    try:
        comm = pcomm.DistComm()
        assert comm.axis("data") is comm and comm.axis("model").size == 1
        _, _, _, port_trainer = _step_setup(0.01, "sgd")
        b = _torch_batch(_batch(5, k=16))
        one = port_trainer()
        one.train_step(b, torch.tensor(1.0))
        par = sharding.ParallelTrainer(port_trainer(), comm=comm)
        with pytest.raises(ValueError, match="cannot be captured"):
            par.train_step(b, 1.0, graphed=True)
        par.train_step(b, 1.0)
        for p, q in zip(par.params, one.params):
            torch.testing.assert_close(p, q, rtol=0, atol=1e-6)
    finally:
        dist.destroy_process_group()


def test_a_deposit_written_in_place_after_a_collective_stays_read():
    """Each rank adds into the tensor it just deposited, right after the
    collective returns, for many rounds, with the interpreter switching
    threads as often as it can: every psum still equals the sum of the
    deposits as they were (a collective reads its peers before it lets any
    rank go on)."""
    import sys

    D, rounds = 16, 40

    def fn(comm):
        x = torch.full((64,), float(comm.rank))
        out = []
        for i in range(rounds):
            out.append(comm.psum(x)[0].clone())
            x.add_(1.0)            # in place, as a gradient sum writes
        return torch.stack(out)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outs = pcomm.run_local(D, fn, timeout=120.0)
    finally:
        sys.setswitchinterval(old)
    base = D * (D - 1) / 2
    want = torch.tensor([base + D * i for i in range(rounds)])
    for o in outs:
        assert torch.equal(o, want)
