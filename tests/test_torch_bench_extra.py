"""The port's extended benchmarks (``tools/bench_extra.py``) on the CPU,
against the reference's ``bench_extra.py`` and the JAX package.

- ``mega_crowd``'s staleness diagnostic at n=1024 (gather and block
  backends, R=1 and R=8): on the rollout's own final positions and
  velocities, the reference's formula (``bench_extra.py:300-318``: the
  JAX package's grid kNN, ``jnp.isin`` row by row) gives the same
  ``knn_overlap``, to float32 rounding of the mean; R=1 gives 1.0 as the
  reference does without computing it.
- ``main`` at tiny sizes prints the reference's twelve lines in its order,
  with its metric names and keys (read from ``bench_extra.py``'s source),
  plus the device line first and the eager decision latency after the
  planning line.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bench_reference import key_tree, printed_dicts
from mprl_parity import two_torch_threads  # noqa: F401
from relationalgraphlearning_tpu.ops.sparse import (
    knn_graph_auto as jknn_auto)
from relationalgraphlearning_tpu_torch.tools import bench_extra as be


def _reference_overlap(pos, vel, R):
    fpos = jnp.asarray(pos.numpy())
    stale = jknn_auto(fpos, 16)
    fresh = jknn_auto(fpos + jnp.asarray(vel.numpy()) * 0.25 * R, 16)
    both = jax.vmap(lambda a, b: jnp.isin(b, a).mean())(stale, fresh)
    return float(jnp.mean(both))


@pytest.mark.parametrize("R", [1, 8])
@pytest.mark.parametrize("backend,packed", [("gather", False),
                                            ("block", True)])
def test_knn_overlap_is_the_references(backend, packed, R):
    m = be.mega_crowd(1024, steps=8, backend=backend, packed=packed,
                      rebuild_every=R, device="cpu")
    pos, vel = m["final"]
    if R == 1:
        assert m["knn_overlap"] == 1.0
        return
    want = _reference_overlap(pos, vel, R)
    assert 0.5 < want < 1.0
    assert abs(m["knn_overlap"] - want) < 1e-6
    assert m["coverage"] == 1.0 and m["agent_steps_per_s"] > 0
    assert not any(m["launches"].values())   # CPU: the plain versions


def test_main_prints_the_references_lines(capsys):
    records = be.main(["--device", "cpu", "--edges_n", "512", "--inner",
                       "2", "--crowd_n", "1024", "--big_n", "2048",
                       "--batch", "2", "--steps", "2", "--mega_steps", "8",
                       "--trials", "1"])
    lines = [json.loads(s) for s in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[0] == {"device": "cpu"}
    assert lines[2]["metric"] == "planning decision latency (eager)"
    ours = [lines[1]] + lines[3:]
    want = printed_dicts("bench_extra.py")
    assert len(ours) == len(want) == 12
    for line, (keys, metric) in zip(ours, want):
        assert line["metric"] == metric
        assert key_tree(line) == keys, metric
    assert [r[0] for r in records] == lines[1:]
    for line in ours:
        if "coverage" in line:
            assert line["coverage"] == 1.0, line
        if "knn_overlap" in line:
            assert 0.5 < line["knn_overlap"] < 1.0, line
    plan = records[0][1]
    assert plan["decisions_per_s"] > 0 and not plan["graphed"]
