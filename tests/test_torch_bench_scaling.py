"""The port's weak-scaling tool (``tools/bench_scaling.py``) on the CPU.

- ``measure`` at D=2 (each method, n = 2·512): the chained partitioned
  forwards end where the same chain on one device ends (SparseRGL over the
  whole graph, each output re-injected as ``bench_scaling.py:55-58`` does),
  within the reference's partitioned-forward tolerance, rtol 2e-4 /
  atol 2e-5 (``tests/test_parallel.py:99-100``).
- ``main`` and ``main --mega`` print the reference's lines with its keys
  (read from ``bench_scaling.py``'s source).
- The helpers ``chip_smoke.py`` phase 11 runs (``partition_inputs``,
  ``partition_row``, ``mega_row``) are this module's.
"""

import json

import pytest
import torch

from bench_reference import key_tree, printed_dicts
from mprl_parity import two_torch_threads  # noqa: F401
from relationalgraphlearning_tpu_torch.tools import bench_scaling as bs

NPS = 512


@pytest.mark.parametrize("method", ["ring", "allgather", "block_halo"])
def test_measure_matches_one_device(method):
    r = bs.measure(method, 2, n_per_shard=NPS, inner=2, reps=1,
                   device="cpu")
    cfg = dict(bs.PARTITION, n_per_rank=NPS)
    states, cols, *_ = bs.partition_inputs(2, method, "cpu", cfg=cfg)
    model = bs.seeded_value_net("gather", "cpu").graph_model
    s = states
    with torch.no_grad():
        for _ in range(2):
            h = model(s, cols)
            s = torch.cat([s[:, :2], h[:, :2] * 1e-6, s[:, 4:]], dim=-1)
    assert r["n"] == 2 * NPS and r["medges_per_s"] > 0
    torch.testing.assert_close(r["states"], s, **bs.PARTITION_TOL)
    assert (r["states"][:, 2:4] != 0).any()   # the forwards were re-injected
    assert not any(r["launches"].values())    # CPU: the plain versions


def test_main_prints_the_references_lines(capsys):
    bs.main(["--device", "cpu", "--ranks", "1,2", "--n_per_shard",
             str(NPS), "--reps", "1"])
    lines = [json.loads(s) for s in
             capsys.readouterr().out.strip().splitlines()]
    (mega_keys, _), (keys, _) = printed_dicts("bench_scaling.py",
                                              "measure_mega") + \
        printed_dicts("bench_scaling.py")
    assert [line["metric"] for line in lines] == [
        f"partitioned edges/s ({m}, D={d}, weak)"
        for m in ("ring", "allgather", "block_halo") for d in (1, 2)]
    for line in lines:
        assert key_tree(line) == keys
    assert lines[0]["scaling_efficiency_vs_D1"] == 1.0
    bs.main(["--device", "cpu", "--mega", "--ranks", "2", "--n_per_shard",
             str(NPS), "--reps", "1"])
    line, = [json.loads(s) for s in
             capsys.readouterr().out.strip().splitlines()]
    assert key_tree(line) == mega_keys
    assert line["metric"].startswith(
        f"partitioned mega-crowd agent-steps/s (D=2, n={2 * NPS}, R=8")
    assert line["win_cov"] == 1.0


def test_phase_11_rows_live_here():
    import chip_smoke
    assert chip_smoke.bs is bs
    assert chip_smoke.PARTITION is bs.PARTITION and chip_smoke.MEGA is bs.MEGA
    for name in ("partition_row", "mega_row", "partition_inputs",
                 "partition_chain_rank", "mega_values_check"):
        assert not hasattr(chip_smoke, name), name
