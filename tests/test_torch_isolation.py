"""The port stands alone: importing every module of
``relationalgraphlearning_tpu_torch`` (and ``chip_smoke.py``'s imports) pulls
in neither ``jax`` nor any module of the JAX package, and on the CPU no
kernel wrapper (#1-#7) launches (counts its launch) at all.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import torch

from relationalgraphlearning_tpu_torch.ops import (
    ab_block, fused_block, fused_chunk, fused_gather)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "relationalgraphlearning_tpu_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import relationalgraphlearning_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                              pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import relationalgraphlearning_tpu_torch.tools.ab_kernel
for leaf in ("tools.ab_kernel", "types", "geometry", "checkpoints",
             "envs.scenarios", "envs.reward", "envs.social_force",
             "envs.crowd_sim", "models.rgl", "models.value_estimator",
             "models.state_predictor", "models.mprl_networks",
             "policies.action_space", "policies.base",
             "policies.state_transform", "policies.model_predictive_rl",
             "training.explorer", "cli.test"):
    assert "relationalgraphlearning_tpu_torch." + leaf in names, leaf
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "relationalgraphlearning_tpu"))
print(len(names), bad)
"""


def test_importing_the_port_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n) >= 35  # every module was found and imported
    assert bad == "[]", bad


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_names_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for mod in _imported_roots(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "chex",
                                "relationalgraphlearning_tpu"), (f, mod)


def test_cpu_wrappers_count_no_launch():
    fused_block.reset_launch_counts()
    fused_gather.reset_launch_counts()
    fused_chunk.reset_launch_counts()
    ab_block.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    nb, B, C, d, n = 2, 64, 48, 32, 128
    q = torch.randn(nb * B, d, generator=g)
    x = torch.randn(n, d, generator=g)
    cand = torch.sort(torch.randperm(n + 1, generator=g)[:nb * C]
                      .reshape(nb, C), dim=-1).values
    emask = torch.rand(nb, B, C, generator=g) < 0.1
    fused_block.block_attention_fused(q, x, x, cand, emask)
    fused_block.block_attention_fused(q, x, torch.randn(n, 48, generator=g),
                                      cand, fused_block.pack_emask(emask))
    fused_block.fused_block_attention(
        q.reshape(nb, B, d), x[cand.clamp(max=n - 1)],
        x[cand.clamp(max=n - 1)], emask)
    cols = torch.randint(0, n, (nb * B, 8), generator=g)
    fused_gather.fused_gather_attention(q, x, x, cols)
    starts, tail, mbits, _ = fused_chunk.chunk_window(
        cols, B, nch=1, ct=64, thresh=4, chunk=32)
    fused_chunk.chunk_block_attention(q, q, starts, tail, mbits)
    xg = x[cand.clamp(max=n - 1)]
    for dtype in (torch.float32, torch.bfloat16):
        ab_block.ab_block_attention(
            q.reshape(nb, B, d).to(dtype), xg.to(dtype),
            fused_block.pack_emask(emask), div_after=True, intmask=True)
    assert fused_block.launch_counts() == {
        "fused_block_attention_packed_shared": 0,
        "fused_block_attention_packed": 0, "fused_block_attention": 0}
    assert fused_gather.launch_counts() == {"fused_gather_attention": 0}
    assert fused_chunk.launch_counts() == {"chunk_block_attention": 0}
    assert ab_block.launch_counts() == {"ab_block_attention": 0}
