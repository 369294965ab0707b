"""Multi-process runs: ``torch.distributed`` in place of ``jax.distributed``.

Port of ``relationalgraphlearning_tpu/parallel/distributed.py``.
``initialize`` reads the same launch variables as the reference, so a
launch line carries over (one process a card):

    JAX_COORDINATOR=host0:8476 NPROC=4 PROC_ID=$i python -m ...

and with one process it does nothing. ``launch`` runs a per-rank function
of the port (``fn(comm, ...)`` with a ``comm.DistComm``) in spawned
processes of this host, which meet through a file store (no port is
opened for the rendezvous), and returns what they return: the tests' and
``chip_smoke.py``'s way to run the per-rank code as separate processes.
"""

from __future__ import annotations

import datetime
import logging
import multiprocessing
import os
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Optional

import torch
from torch.utils._pytree import tree_map

from relationalgraphlearning_tpu_torch.parallel.comm import DistComm
from relationalgraphlearning_tpu_torch.parallel.mesh import (
    ROW, combine, split_rows)

log = logging.getLogger(__name__)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialise ``torch.distributed`` from the arguments or the
    environment (``JAX_COORDINATOR``, ``NPROC``, ``PROC_ID`` when an
    argument is None): NCCL where each process can have a card of its
    own, gloo otherwise. Returns
    True when a multi-process group was initialised, False for one process
    (a no-op: the program runs as it would without it)."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("NPROC", "1"))
    if process_id is None:
        process_id = int(os.environ.get("PROC_ID", "0"))
    if coordinator_address is None or num_processes <= 1:
        log.info("single-process run (no coordinator configured)")
        return False
    # NCCL when every process can have a card of its own; gloo otherwise
    # (processes sharing one card: NCCL refuses two ranks on one device)
    nccl = (torch.cuda.is_available()
            and torch.cuda.device_count() >= num_processes)
    backend = "nccl" if nccl else "gloo"
    if nccl:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    log.info("torch.distributed initialized (%s): process %d/%d", backend,
             process_id, num_processes)
    return True


def is_primary() -> bool:
    """True on the process that should write checkpoints and logs."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _to(x, device):
    """The tensors and modules of a tree to ``device``."""
    return tree_map(lambda t: t.to(device) if isinstance(
        t, (torch.Tensor, torch.nn.Module)) else t, x)


def _child(rank: int, size: int, workdir: str, fn: Callable, device: str,
           timeout: float) -> None:
    """One spawned rank: join the group, run ``fn``, save what it returns
    (or the traceback) in ``workdir``."""
    import torch.distributed as dist

    work = Path(workdir)
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        elif dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "gloo", init_method=f"file://{work / 'store'}", rank=rank,
            world_size=size, timeout=datetime.timedelta(seconds=timeout))
        try:
            args = _to(torch.load(work / f"args{rank}.pt",
                                  weights_only=False), device)
            out = fn(DistComm(), *args)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            torch.save(_to(out, "cpu"), work / f"out{rank}.pt")
        finally:
            dist.destroy_process_group()
    except BaseException:
        (work / f"err{rank}.txt").write_text(traceback.format_exc())
        raise


def launch(fn: Callable, size: int, replicated=(), row_sharded=(),
           out_specs=ROW, device="cuda", timeout: float = 300.0):
    """``fn(comm, *replicated, *rows)`` in ``size`` spawned processes over
    gloo (they share this host's CPU or one card), as ``Mesh.run`` runs it
    on threads: ``rows`` are each rank's slices of ``row_sharded``, the
    outputs combined by ``out_specs``. ``fn`` must be importable by name (a
    module-level function of the port). Arguments go to ``device`` in each
    process, the card unless the caller asks for the CPU (``device="cpu"``);
    results come back on the CPU.

    Raises the failing rank's traceback if a process fails, and
    ``TimeoutError`` (after terminating them) if the processes are not done
    within ``timeout`` seconds; each process's group times out there too.
    """
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch on 'cuda' with no CUDA device; pass "
                           "device='cpu' to run the ranks on the CPU")
    parts = [split_rows(a, size) for a in row_sharded]
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="rgl_launch_") as workdir:
        work = Path(workdir)
        for r in range(size):
            torch.save((*replicated, *(p[r] for p in parts)),
                       work / f"args{r}.pt")
        procs = [ctx.Process(target=_child, name=f"rank{r}", args=(
            r, size, workdir, fn, str(device), timeout))
            for r in range(size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while (any(p.is_alive() for p in procs)
                   and time.monotonic() < deadline
                   and not any(p.exitcode for p in procs)):
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join(10)
        errs = sorted(work.glob("err*.txt"), key=lambda f: f.stat().st_mtime)
        if errs:                    # the first rank to fail
            raise RuntimeError(f"rank {errs[0].stem[3:]} failed:\n"
                               f"{errs[0].read_text()}")
        missing = [r for r in range(size)
                   if not (work / f"out{r}.pt").exists()]
        if missing:
            raise TimeoutError(f"ranks {missing} gave no result (a limit of "
                               f"{timeout} s; exit codes "
                               f"{[p.exitcode for p in procs]})")
        outs = [torch.load(work / f"out{r}.pt", weights_only=False)
                for r in range(size)]
    return combine(outs, out_specs)
