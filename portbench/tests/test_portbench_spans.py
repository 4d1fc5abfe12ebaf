"""The reader of the program's spans (``portbench/program_spans.py``,
``metrics/schedule_ms.py``) on a hand-made timeline, and a tick-clock
CPU run whose host and counter metrics read what they read before the
program had spans."""
from types import SimpleNamespace as Ctx

import pytest

from portbench import program_spans as P
from portbench.run import read_metrics, run_cell
from portbench.spec import load_cell
from portbench.trace import TraceData

MS = 1e-3

#: two steps of 48 and 46 ms: a prefill round, then decodes
HOST = [
    ("portbench.engine_step", 0, 50), ("engine.step", 1, 49),
    ("engine.schedule", 2, 4), ("engine.prefill", 5, 25),
    ("engine.round", 5, 25), ("engine.upload", 6, 8), ("aten::copy_", 6, 8),
    ("engine.replay", 9, 12), ("cudaGraphLaunch", 9, 12),
    ("engine.decode", 30, 45), ("engine.replay", 31, 40),
    ("cudaGraphLaunch", 31, 40),
    ("portbench.submit", 50, 52),
    ("portbench.engine_step", 52, 100), ("engine.step", 53, 99),
    ("engine.schedule", 54, 57), ("engine.decode", 60, 90),
    ("engine.replay", 60, 70), ("cudaGraphLaunch", 60, 70)]
DEVICE = [("k1", 13, 28), ("k2", 40, 46), ("k3", 70, 95)]


def trace(device=DEVICE, host=HOST):
    sec = [(n, s * MS, e * MS) for n, s, e in host]
    return TraceData(window=(0.0, 100 * MS),
                     device=[(n, s * MS, e * MS) for n, s, e in device],
                     host=sec)


@pytest.mark.parametrize("name, ms", [
    ("engine.step", 47.0), ("engine.schedule", 2.5), ("engine.prefill", 10.0),
    ("engine.upload", 1.0), ("engine.replay", 11.0), ("engine.decode", 22.5),
    ("engine.fetch", 0.0)])
def test_host_ms_a_step_by_span(name, ms):
    assert P.per_step_ms(trace(), name) == pytest.approx(ms)


def test_gaps_are_the_trace_readers_own():
    t = trace()
    got = P.gaps(t)
    assert [(s / MS, e / MS) for s, e in got] == pytest.approx(
        [(46, 70), (0, 13), (28, 40), (95, 100)])
    assert [e - s for s, e in got] == pytest.approx(
        [d for _, d in t.idle_gaps()])
    assert sum(e - s for s, e in got) == pytest.approx(
        t.window_s - t.busy_s())


def test_idle_by_the_innermost_span_around_it():
    t = trace()
    by = P.idle_by_span(t)
    want = {"engine.replay": 22, "engine.step": 15, P.OUTSIDE: 6,
            "engine.schedule": 5, "engine.round": 3, "engine.upload": 2,
            "engine.decode": 1}
    assert list(by) == list(want)
    for k, v in want.items():
        assert by[k] == pytest.approx(v * MS), k
    assert sum(by.values()) == pytest.approx(t.window_s - t.busy_s())
    between = trace(device=[("k", 0, 45), ("k", 55, 100)])
    assert P.idle_by_span(between) == pytest.approx(
        {"engine.step": 5 * MS, P.OUTSIDE: 4 * MS,
         "engine.schedule": 1 * MS})


def test_gap_labels_carry_the_innermost_program_span():
    got = P.gap_labels(trace(), k=4)
    assert [g[1] / MS for g in got] == pytest.approx([24, 13, 12, 5])
    assert [g[0] for g in got] == [
        "portbench.engine_step: cudaGraphLaunch",
        "portbench.engine_step > engine.prefill > engine.round"
        " > engine.upload: cudaGraphLaunch",
        "portbench.engine_step > engine.decode > engine.replay:"
        " cudaGraphLaunch",
        "portbench.engine_step"]
    between = trace(device=[("k", 0, 45), ("k", 55, 100)],
                    host=HOST + [("aten::to", 46, 54)])
    assert P.gap_labels(between, k=1)[0][0] == \
        "portbench.submit > outside engine.step: aten::to"


DEFS = [{"name": "schedule_ms.backlog", "unit": "ms"}]


def test_reader_by_name():
    ctx = Ctx(rec=None, setup_s=1.0, trace=trace(), shape=None, peaks={})
    got = {k: v["value"] for k, v in read_metrics(DEFS, ctx).items()}
    assert got == pytest.approx({"schedule_ms.backlog": 2.5})
    # no device trace: nothing is read
    ctx.trace = None
    assert read_metrics(DEFS, ctx) == {}


def test_a_program_without_spans_reads_nothing():
    """The tree before the spans: no ``engine.*`` range in the trace.
    The reader returns nothing and raises nothing."""
    bare = trace(host=[h for h in HOST if not h[0].startswith("engine.")])
    ctx = Ctx(rec=None, setup_s=1.0, trace=bare, shape=None, peaks={})
    assert read_metrics(DEFS, ctx) == {}
    assert P.idle_by_span(bare) == pytest.approx({P.OUTSIDE: 54 * MS})
    assert P.gap_labels(bare, k=1)[0][0] == \
        "portbench.engine_step > outside engine.step: cudaGraphLaunch"


@pytest.mark.parametrize("trace_on", [False, True])
def test_tick_run_reads_what_it_read_before_the_spans(trace_on):
    """On the tick clock a step reads one tick, whatever the spans do
    inside it; the pool's peak and the throughput are the ones the tree
    before the spans reads (15.234375 %, 533.33 tokens/s)."""
    res = run_cell(load_cell("qwen2-moe-a2.7b.chat_backlog"), 2 ** 33 + 17,
                   1.0, trace_on, device="cpu", small=True,
                   pool_tokens=4096, log=lambda *a, **k: None, tick=0.005)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    if trace_on:
        assert got == pytest.approx({"step_wall_ms.backlog": 5.0,
                                     "kv_pool_used_peak": 15.234375})
    else:
        assert got["output_tokens_per_s"] == pytest.approx(1600 / 3)
    assert res["correct"]
