"""The train CLI over a mesh (``parallel/sharding.py`` through
``training/train_loop.py``), on the CPU at the toy counts of
``test_torch_cli_train.py``:

- ``cli.train --mesh_data 2`` (two rank threads) fills the same replay
  buffer as the run without a mesh;
- ``cli.train --multihost`` as two gloo processes (NPROC=2, PROC_ID,
  JAX_COORDINATOR on localhost) writes the same checkpoint as the
  threads, bit for bit, and only process 0 writes the output directory.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

from mprl_parity import two_torch_threads  # noqa: F401
from relationalgraphlearning_tpu_torch.cli import train as train_cli
from relationalgraphlearning_tpu_torch.training import checkpoint as ckpt
from relationalgraphlearning_tpu_torch.training import train_loop

from test_torch_cli_train import FLAGS, ROOT, TOY_CONFIG


def _run(tmp, name, extra, monkeypatch):
    """The toy CLI run in ``tmp/name`` -> (result, every batch pushed into
    the replay buffer, in order)."""
    cfg = tmp / "toy.py"
    cfg.write_text(TOY_CONFIG)
    pushes = []
    real_push = train_loop.rb.push

    def push(buffer, batch):
        pushes.append(batch)
        return real_push(buffer, batch)

    monkeypatch.setattr(train_loop.rb, "push", push)
    result = train_cli.main(["--config", str(cfg), "--output_dir",
                             str(tmp / name), *FLAGS, *extra])
    monkeypatch.undo()
    return result, pushes


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    with pytest.MonkeyPatch.context() as mp:
        result, pushes = _run(tmp, "mesh", ["--mesh_data", "2"], mp)
    return tmp, result, pushes


def test_cli_train_on_a_mesh_fills_the_same_buffer(mesh_run, tmp_path,
                                                    monkeypatch):
    """``cli.train --mesh_data 2`` at the toy counts of
    ``test_torch_cli_train.py`` against the same run without a mesh: every
    push into the replay buffer equal (the imitation phase's
    demonstrations and the RL phase's transitions bit for bit, but for the
    RL phase's TD values at 1e-5). The final weights are not compared: 40
    Adam steps from gradients equal to rounding may differ by up to the
    learning rate where a gradient is near 1e-8 (the step is held to one
    device in ``test_torch_sharding.py``)."""
    _, mesh, mesh_pushes = mesh_run
    one, one_pushes = _run(tmp_path, "one", [], monkeypatch)
    pushes = {"one": one_pushes, "mesh": mesh_pushes}
    assert mesh["episodes"] == one["episodes"] >= 6
    assert len(pushes["mesh"]) == len(pushes["one"]) > 2
    for i, (a, b) in enumerate(zip(pushes["one"], pushes["mesh"])):
        for name, x, y in zip(a._fields, a, b):
            # the RL phase's TD values come from the target net, whose
            # weights differ from one device's by the data sum's rounding
            tol = (dict(rtol=1e-5, atol=1e-5) if name == "value"
                   else dict(rtol=0, atol=0))
            torch.testing.assert_close(y, x, **tol, msg=f"push {i}: {name}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_multihost_processes_equal_the_threads(mesh_run, tmp_path):
    """``cli.train --multihost`` as two gloo processes (NPROC=2, PROC_ID,
    JAX_COORDINATOR on localhost) against ``--mesh_data 2`` as threads, at
    the toy counts: the same checkpoint, bit for bit (each process runs
    the threads' arithmetic in the same order); only process 0 writes the
    output directory."""
    tmp, _, _ = mesh_run
    cfg, threads = tmp / "toy.py", tmp / "mesh"
    procs_dir = tmp_path / "procs"
    env = dict(os.environ, JAX_COORDINATOR=f"localhost:{_free_port()}",
               NPROC="2", PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "relationalgraphlearning_tpu_torch.cli.train",
         "--config", str(cfg), "--output_dir", str(procs_dir), *FLAGS,
         "--multihost"], cwd=ROOT, env=dict(env, PROC_ID=str(i)),
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    assert "'processes': True" in logs[0]
    a = ckpt.load(str(threads / "rl_model"))
    b = ckpt.load(str(procs_dir / "rl_model"))
    for part in ("params", "target_params"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    for sa, sb in zip(a["optimizer_state"], b["optimizer_state"]):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k

    def names(d):      # one TensorBoard events file each, named by time
        return sorted("events" if p.name.startswith("events.out") else
                      p.name for p in d.iterdir())

    assert names(procs_dir) == names(threads)
