"""The port's spans, counters and device phases (``utils/profiling.py``) on
the CPU:

- off by default: nothing is recorded, ``span`` and ``device_phase`` hand
  back the shared null context, and no module of the port turns the switch
  on except ``trace``;
- nested spans give their parents and self time (a stepped clock), a
  ``Stopwatch`` keeps its total with the switch off, counters add;
- ``device_phase`` records nothing on the CPU or outside a capture;
- one eager evaluation step, collection step, SGD step and crowd chunk give
  bitwise-equal outputs with tracing on and off, and record their spans;
- ``CaseTable.ensure``'s growth counts ``explorer.case_rows``.

The graphs' phase events are read on the card (``tests/test_torch_cuda.py``).
"""

import itertools
import re
from pathlib import Path

import pytest
import torch

from relationalgraphlearning_tpu_torch.configs.base import load_config_module
from relationalgraphlearning_tpu_torch.envs import mega_crowd
from relationalgraphlearning_tpu_torch.training import replay_buffer as rb
from relationalgraphlearning_tpu_torch.training import train_loop
from relationalgraphlearning_tpu_torch.training.explorer import CaseTable
from relationalgraphlearning_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "relationalgraphlearning_tpu_torch"
TRAIN_CONFIG = ROOT / "configs" / "icra_benchmark" / "mp_separate.py"


@pytest.fixture
def on():
    """The switch on and the registry empty for one test, off after."""
    profiling.reset()
    profiling.enable()
    yield
    profiling.disable()
    profiling.reset()


def test_off_by_default_records_nothing():
    assert not profiling.enabled()
    profiling.reset()
    a, b = profiling.span("a"), profiling.span("b")
    assert a is b is profiling.annotate("c")
    assert profiling.device_phase("p", torch.device("cpu")) is a
    with a, profiling.device_phase("p", torch.device("cuda")):
        profiling.count("n", 3)
    assert profiling.snapshot() == {"spans": {}, "counters": {},
                                    "graphs": {}}


def test_only_trace_turns_the_switch_on():
    """A process that never calls ``trace`` (the benchmark's untraced
    runs) never records: ``enable()`` is called nowhere else in the
    port."""
    callers = [p.relative_to(PORT) for p in PORT.rglob("*.py")
               if re.search(r"\benable\(\)", p.read_text())]
    assert callers == [Path("utils/profiling.py")]
    text = (PORT / "utils" / "profiling.py").read_text()
    body = text[text.index("def trace("):]
    assert "enable()" in body


def test_nested_spans_parents_and_self_time(on, monkeypatch):
    clock = itertools.count()  # each clock read one second on
    monkeypatch.setattr(profiling.time, "perf_counter",
                        lambda: float(next(clock)))
    with profiling.span("outer"):  # reads 0 ... 7
        with profiling.span("inner"):  # 1, 2
            pass
        with profiling.span("inner"):  # 3, 4
            pass
        with profiling.span("other"):  # 5, 6
            pass
    s = profiling.snapshot()["spans"]
    assert s["inner"] == {"count": 2, "total_s": 2.0, "self_s": 2.0,
                          "parents": {"outer": 2}}
    assert s["other"]["parents"] == {"outer": 1}
    assert s["outer"] == {"count": 1, "total_s": 7.0, "self_s": 4.0,
                          "parents": {"": 1}}


def test_spanned_and_stopwatch(on):
    @profiling.spanned("fn")
    def fn(x):
        return x + 1

    assert fn(1) == 2
    watch = profiling.Stopwatch("w")
    with watch:
        fn(2)
    assert watch.seconds > 0
    s = profiling.snapshot()["spans"]
    assert s["fn"]["count"] == 2 and s["fn"]["parents"] == {"": 1, "w": 1}
    profiling.disable()
    before = watch.seconds
    with watch:  # off: its own total still grows, the registry does not
        fn(3)
    assert watch.seconds > before
    assert profiling.snapshot()["spans"]["fn"]["count"] == 2


def test_counters_add(on):
    profiling.count("a")
    profiling.count("a", 2)
    profiling.count("b", 0.5)
    assert profiling.snapshot()["counters"] == {"a": 3, "b": 0.5}
    profiling.reset()
    assert profiling.snapshot()["counters"] == {}


def test_device_phase_is_a_no_op_on_the_cpu(on):
    ph = profiling.device_phase("p", torch.device("cpu"))
    assert ph is profiling.device_phase("q", torch.device("cpu"))
    # outside a capture that captured.Graphed started: nothing either
    assert ph is profiling.device_phase("q", torch.device("cuda"))
    with ph:
        torch.ones(4).add_(1)
    snap = profiling.snapshot()
    assert snap["graphs"] == {}


# -------------------------------------------- the port, tracing on and off
@pytest.fixture(scope="module")
def art():
    config = load_config_module(str(TRAIN_CONFIG))
    a = train_loop.build(config, "model_predictive_rl", 0, "cpu")
    a.policy.init_params(torch.Generator().manual_seed(0))
    a.trainer.update_target()
    return config, a


def _twice(fn):
    """``fn()`` with tracing off, then on -> (off, on, the snapshot)."""
    profiling.reset()
    off = fn()
    profiling.enable()
    try:
        got = fn()
        snap = profiling.snapshot()
    finally:
        profiling.disable()
        profiling.reset()
    return off, got, snap


def _equal(a, b):
    for x, y in zip(a, b, strict=True):
        assert torch.equal(x, y)


def test_eval_step_on_equals_off(art):
    config, a = art
    ex = a.explorer
    carry = ex.initial_carry(config.env.sim.test_seed_offset, range(4))
    with torch.no_grad():
        off, got, snap = _twice(lambda: ex.eval_step(*carry))
    _equal(off, got)
    assert snap["graphs"] == {}


def test_collect_step_on_equals_off(art):
    config, a = art
    ex = a.explorer
    offset = config.env.sim.train_seed_offset
    draws = ex.draws(torch.Generator().manual_seed(3), 4, 4)

    def run():
        carry = ex.init_carry(4, offset)
        return [*(t for part in ex.collect(carry, 4, offset, 0.5, draws)
                  for t in part)]
    off, got, snap = _twice(run)
    _equal(off, got)
    assert snap["spans"]["explorer.collect"]["count"] == 1


def test_sgd_step_on_equals_off(art):
    config, a = art
    tr = a.trainer
    buf = rb.create(256, config.env.sim.human_num, device="cpu")
    g = torch.Generator().manual_seed(0)
    n = 200
    rb.push(buf, rb.Transition(
        torch.randn(n, 9, generator=g), torch.randn(n, 5, 5, generator=g),
        torch.randn(n, generator=g), torch.randn(n, generator=g),
        torch.randn(n, 9, generator=g), torch.randn(n, 5, 5, generator=g),
        torch.ones(n), torch.zeros(n)))
    idx = rb.sample_indices(buf, torch.Generator().manual_seed(1), (1, 32))
    start = tr.state_dict()

    def run():
        tr.load_state(start)
        aux = tr.optimize(buf, idx, use_td=True)
        return [*aux, *(p.detach().clone() for p in tr.params)]
    off, got, snap = _twice(run)
    _equal(off, got)
    assert snap["spans"]["trainer.sweep"]["count"] == 1


def test_crowd_chunk_on_equals_off():
    kw = dict(n=256, K=6, steps=4, backend="block", block_B=64,
              block_C=256, rebuild_every=2, packed=True, device="cpu",
              seed=3)

    def run():
        (p, v), vals, cov = mega_crowd.mega_crowd_rollout(**kw)
        return p, v, vals, cov
    off, got, snap = _twice(run)
    _equal(off, got)
    spans = snap["spans"]
    assert spans["crowd.rebuild"]["count"] == 2
    for child in ("crowd.sort", "crowd.knn", "crowd.window", "crowd.masks"):
        assert spans[child]["parents"] == {"crowd.rebuild": 2}, child
    r = spans["crowd.rebuild"]
    assert 0 <= r["self_s"] < r["total_s"]


def test_case_table_growth_counts_its_rows(on, art):
    config, a = art
    table = CaseTable(a.explorer.env, config.env.sim.train_seed_offset)
    table.ensure(10)  # an empty table grows to 1,024 cases at least
    table.ensure(1000)  # held already
    table.ensure(1500)  # doubles
    snap = profiling.snapshot()
    assert snap["counters"]["explorer.case_rows"] == table.capacity == 2048
    assert snap["spans"]["explorer.case_table_grow"]["count"] == 2
