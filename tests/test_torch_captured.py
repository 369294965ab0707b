"""The capture helper of the port (``captured.py``) off the card: what it
refuses and what it counts, and the launch registry of ``ops/_build.py``
that every kernel wrapper counts into. The graphs themselves run only on a card
(``tests/test_torch_cuda.py``); the entry points that use them are held to
their eager loops on CPU tensors in the chain, harness and mega-crowd test
files.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from relationalgraphlearning_tpu_torch import captured
from relationalgraphlearning_tpu_torch.configs.base import (
    EnvConfig, PolicyConfig)
from relationalgraphlearning_tpu_torch.envs import orca as envs_orca
from relationalgraphlearning_tpu_torch.envs.orca import ORCAParams
from relationalgraphlearning_tpu_torch.ops import (
    _build, ab_block, fused_block, fused_chunk, fused_gather, roofline)
from relationalgraphlearning_tpu_torch.policies.model_predictive_rl import (
    ModelPredictiveRLPolicy)


def test_cpu_tensors_are_refused():
    with pytest.raises(ValueError, match="CUDA"):
        captured.Graphed(lambda h: h * 2, torch.ones(4))
    with pytest.raises(ValueError, match="CUDA"):
        captured.Graphed(lambda: None)


def test_launch_counts_cover_every_kernel_wrapper():
    captured.reset_launch_counts()
    for kernel, n in (("fused_block_attention_packed_shared", 3),
                      ("fused_gather_attention", 2),
                      ("ab_block_attention", 1), ("orca_velocity", 4)):
        for _ in range(n):
            _build.count_launch(kernel)
    counts = captured.launch_counts()
    assert counts == _build.launch_counts()
    assert set(counts) >= {"fused_block_attention_packed_shared",
                           "fused_block_attention_packed",
                           "fused_block_attention", "fused_gather_attention",
                           "chunk_block_attention", "ab_block_attention",
                           "orca_velocity"}
    assert counts["fused_gather_attention"] == 2
    assert counts["orca_velocity"] == 4
    assert sum(counts.values()) == 10
    assert captured.launches_since(counts) == dict.fromkeys(counts, 0)
    captured.reset_launch_counts()
    assert set(captured.launch_counts().values()) == {0}
    assert captured.launches_since(counts)["orca_velocity"] == -4


def test_an_unregistered_kernel_cannot_count():
    with pytest.raises(KeyError):
        _build.count_launch("no_such_kernel")
    assert "no_such_kernel" not in _build.launch_counts()


def test_ranks_as_threads_count_into_one_registry():
    captured.reset_launch_counts()

    def rank():
        for _ in range(2000):
            _build.count_launch("fused_block_attention_packed_shared")

    threads = [threading.Thread(target=rank) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    counts = captured.launch_counts()
    assert counts.pop("fused_block_attention_packed_shared") == 8 * 2000
    assert not any(counts.values())
    captured.reset_launch_counts()


def _block_args():
    g = torch.Generator().manual_seed(0)
    nb, B, C, d, n = 2, 32, 40, 16, 96
    qb = torch.randn(nb, B, d, generator=g)
    x = torch.randn(n, d, generator=g)
    cand = torch.sort(torch.randperm(n + 1, generator=g)[:nb * C]
                      .reshape(nb, C), dim=-1).values
    emask = torch.rand(nb, B, C, generator=g) < 0.2
    return qb, x, cand, emask


def _shared():
    qb, x, cand, emask = _block_args()
    return (qb, x, cand, fused_block.pack_emask(emask))


def _separate():
    qb, x, cand, emask = _block_args()
    return (qb, x, torch.randn(x.shape[0], 8), cand,
            fused_block.pack_emask(emask))


def _dense():
    qb, x, cand, emask = _block_args()
    xg = x[cand.clamp(max=x.shape[0] - 1)]
    return (qb, xg, xg, emask)


def _gather():
    qb, x, _, _ = _block_args()
    cols = torch.randint(0, x.shape[0], (x.shape[0], 4),
                         generator=torch.Generator().manual_seed(1))
    return (x, x, x, cols)


def _chunk():
    _, x, _, _ = _block_args()
    cols = torch.randint(0, 96, (96, 4),
                         generator=torch.Generator().manual_seed(2))
    starts, tail, mbits, _ = fused_chunk.chunk_window(
        cols, 32, nch=1, ct=48, thresh=4, chunk=32)
    return (x, x, starts, tail, mbits)


def _ab():
    qb, x, cand, emask = _block_args()
    return (qb, x[cand.clamp(max=x.shape[0] - 1)],
            fused_block.pack_emask(emask))


def _orca():
    g = torch.Generator().manual_seed(3)
    n, M = 16, 5
    return (torch.randn(n, 2, generator=g), torch.randn(n, 2, generator=g),
            torch.full((n,), 0.3), torch.randn(n, 2, generator=g),
            torch.ones(n), torch.randn(n, M, 2, generator=g),
            torch.randn(n, M, 2, generator=g), torch.full((n, M), 0.3),
            torch.rand(n, M, generator=g) > 0.3, ORCAParams())


class _Planner:
    """The rgl_value kernel's caller: the planner's value, which takes
    ``networks.value`` for CPU tensors."""

    @staticmethod
    def rgl_value(robot, humans):
        policy = ModelPredictiveRLPolicy(PolicyConfig(), EnvConfig(),
                                         device="cpu")
        policy.init_params(torch.Generator().manual_seed(4))
        return policy.value(robot, humans)


def _value():
    g = torch.Generator().manual_seed(4)
    humans = torch.randn(3, 1, 5, 5, generator=g)
    return (torch.randn(3, 81, 9, generator=g), humans.expand(3, 81, 5, 5))


# every kernel wrapper of ops/: (its module, CPU arguments)
WRAPPERS = {
    "fused_block_attention_packed_shared": (fused_block, _shared),
    "fused_block_attention_packed": (fused_block, _separate),
    "fused_block_attention": (fused_block, _dense),
    "fused_gather_attention": (fused_gather, _gather),
    "chunk_block_attention": (fused_chunk, _chunk),
    "ab_block_attention": (ab_block, _ab),
    "orca_velocity": (envs_orca, _orca),
    "fma_chain": (roofline, lambda: (torch.ones(8), 4, 2)),
    "rgl_value": (_Planner, _value),
}


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_every_kernel_wrapper_is_registered_and_counts_nothing_on_the_cpu(
        kernel):
    module, args = WRAPPERS[kernel]
    assert kernel in _build.launch_counts()
    _build.reset_launch_counts()
    out = getattr(module, kernel)(*args())
    assert torch.isfinite(out.float()).all()
    assert not any(_build.launch_counts().values())


_PROBE = r"""
import importlib, pkgutil, sys
import relationalgraphlearning_tpu_torch.ops as ops
from relationalgraphlearning_tpu_torch.ops import _build
names = [m.name for m in pkgutil.iter_modules(ops.__path__)]
for name in names:
    importlib.import_module("relationalgraphlearning_tpu_torch.ops." + name)
libraries = [v for m in list(sys.modules.values())
             if m is not None and m.__name__.startswith(ops.__name__)
             for v in vars(m).values() if isinstance(v, _build.Library)]
maps = open("/proc/self/maps").read()
print(len(names), len(libraries), len(_build._loaded),
      sum(lib._lib is not None for lib in libraries),
      str(_build.BUILD_DIR) in maps, sorted(_build.launch_counts()))
"""


def test_importing_every_ops_module_loads_no_library():
    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(root)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, libs, loaded, bound, mapped, names = out.stdout.strip().split(" ", 5)
    assert int(n) >= 10 and int(libs) == 7
    assert (loaded, bound, mapped) == ("0", "0", "False")
    assert names == str(sorted(WRAPPERS))
