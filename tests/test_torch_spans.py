"""The serving step's spans and prefill grid counters
(``repro_torch.serving.spans``): with the profiler off a span makes no
call into it and still feeds ``Engine.phase_stats``; under
``torch.profiler`` each span is a range nested as the step's phases
nest; ``prefill_tokens`` / ``prefill_grid_tokens`` count a round's real
tokens and its padded grid, and move neither in ``warmup`` nor on an
aborted attempt."""
import dataclasses

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core import Request, TheoreticalCostModel, get_hardware
from repro_torch.core import make_scheduler
from repro_torch.core import stat_keys as SK
from repro_torch.models import model as M
from repro_torch.serving import Engine, EngineConfig, spans
from repro_torch.serving.faults import FaultSpec
from repro_torch.serving.spans import span

torch.set_num_threads(2)

NSLOTS, CHUNK = 4, 16


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              dtype="float32")
    return cfg, M.init_params(cfg, 0, device="cpu")


def engine(model, faults=None, M_kv=200):
    cfg, params = model
    cost = TheoreticalCostModel(cfg, get_hardware("tpu_v5e"))
    sched = make_scheduler("vllm", M_kv, S=128, replacement="srf",
                           page_size=8)
    ecfg = EngineConfig(nslots=NSLOTS, cache_len=64, chunk=CHUNK,
                        plane="paged", page_size=8, faults=faults)
    return Engine(cfg, params, sched, ecfg, cost_model=cost, device="cpu")


def reqs(cfg, lens=((40, 3), (20, 4))):
    g = torch.Generator().manual_seed(3)
    return [Request(rid=i, input_len=n, output_len=o, arrival=0.0,
                    prompt=torch.randint(0, cfg.vocab_size, (n,),
                                         generator=g).tolist())
            for i, (n, o) in enumerate(lens)]


def serve(eng, requests):
    for r in requests:
        eng.submit(r)
    n = 0
    while eng.sched.has_work():
        eng.step()
        n += 1
    return n


def test_span_names_and_keys():
    assert all(n.startswith(spans.PREFIX) for n in spans.NAMES)
    assert len(set(spans.NAMES)) == len(spans.NAMES) == 15
    # the three keys operators already read keep their names
    assert spans.KEY[spans.ATTACH] == SK.ATTACH_S
    assert spans.KEY[spans.PREFILL] == SK.PREFILL_S
    assert spans.KEY[spans.UPLOAD] == SK.UPLOAD_S
    assert spans.KEY[spans.REPLAY] == "replay_s"
    assert list(spans.KEY) == list(spans.NAMES)


def _boom(*a, **k):
    raise AssertionError("a span called into the profiler while it was off")


def test_profiler_off_makes_no_profiler_call(model, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _boom)
    stats = {}
    with span(stats, spans.SCHEDULE):
        pass
    with pytest.raises(KeyError):           # time is kept when it raises
        with span(stats, spans.FETCH):
            raise KeyError
    assert set(stats) == {"schedule_s", "fetch_s"}
    eng = engine(model).warmup()
    assert set(eng.phase_stats) == set(spans.KEY.values())
    assert not any(eng.phase_stats.values())        # warmup times nothing
    steps = serve(eng, reqs(model[0]))
    ps = eng.phase_stats
    for k in ("step_s", "schedule_s", "attach_s", "commit_s", "prefill_s",
              "round_s", "upload_s", "replay_s", "fetch_s", "decode_s",
              "block_tables_s", "account_s", "drain_s"):
        assert ps[k] > 0, k
    assert ps["step_s"] >= ps["prefill_s"] >= ps["round_s"] \
        >= ps["upload_s"]
    assert steps > 1


def _ancestors(e):
    out = []
    p = e.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def test_profiler_on_records_nested_ranges(model):
    eng = engine(model).warmup()
    requests = reqs(model[0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        steps = serve(eng, requests)
    ev = [e for e in prof.events() if e.device_type == DeviceType.CPU
          and e.name.startswith(spans.PREFIX)]
    by = {}
    for e in ev:
        by.setdefault(e.name, []).append(_ancestors(e))
    assert len(by[spans.STEP]) == steps
    assert all(a == [] for a in by[spans.STEP])
    for name in (spans.SCHEDULE, spans.PREEMPT, spans.SWAP_IN, spans.ATTACH,
                 spans.COMMIT, spans.PREFILL, spans.DECODE, spans.ACCOUNT,
                 spans.DRAIN):
        assert by[name] and all(a == [spans.STEP] for a in by[name]), name
    assert len(by[spans.SCHEDULE]) == steps
    assert len(by[spans.ROUND]) == eng.prefill_rounds
    assert all(a == [spans.PREFILL, spans.STEP] for a in by[spans.ROUND])
    inside = {tuple(a) for n in (spans.UPLOAD, spans.REPLAY, spans.FETCH,
                                 spans.BLOCK_TABLES) for a in by[n]}
    assert inside == {(spans.ROUND, spans.PREFILL, spans.STEP),
                      (spans.DECODE, spans.STEP),
                      (spans.PREFILL, spans.STEP)}
    for name in (spans.REPLAY, spans.FETCH):
        assert [spans.ROUND, spans.PREFILL, spans.STEP] in by[name]
        assert [spans.DECODE, spans.STEP] in by[name]
    assert len(by[spans.REPLAY]) == eng.prefill_rounds + eng.decode_steps
    # nothing of the program's is left open or recorded outside a step
    assert all(e.time_range.end >= e.time_range.start for e in ev)


def test_prefill_counters_against_a_hand_planned_batch(model):
    """Both prompts enter the first step whole (S = 128): rounds of
    (16, 16), (16, 4) and (8,) tokens, padded to buckets 16, 16 and 8
    on grids of the row rungs 4, 4 and 1 (of 4 slots)."""
    eng = engine(model).warmup()
    assert eng.buckets == [8, 16]
    for r in reqs(model[0]):
        eng.submit(r)
    eng.step()
    assert eng.prefill_rounds == 3
    assert eng.prefill_tokens == 40 + 20
    assert eng.prefill_grid_tokens == 4 * 16 + 4 * 16 + 1 * 8
    assert eng.prefill_rounds_by_rows == {4: 2, 1: 1}
    while eng.sched.has_work():             # decodes only from here
        eng.step()
    assert (eng.prefill_rounds, eng.prefill_tokens,
            eng.prefill_grid_tokens, eng.prefill_rounds_by_rows) \
        == (3, 60, 136, {4: 2, 1: 1})


def test_counters_still_in_warmup_and_aborted_attempts(model):
    eng = engine(model).warmup()
    assert (eng.prefill_rounds, eng.prefill_tokens,
            eng.prefill_grid_tokens, eng.prefill_rounds_by_rows) \
        == (0, 0, 0, {})
    lens = ((40, 3), (20, 4), (33, 2), (9, 5), (27, 3))
    serve(eng, reqs(model[0], lens))
    clean = (eng.prefill_rounds, eng.prefill_tokens, eng.prefill_grid_tokens,
             eng.prefill_rounds_by_rows)
    faulted = engine(model, faults=FaultSpec(seed=5, p_alloc=0.8)).warmup()
    serve(faulted, reqs(model[0], lens))
    assert faulted.recovery_stats[SK.ROLLBACKS] > 0
    assert (faulted.prefill_rounds, faulted.prefill_tokens,
            faulted.prefill_grid_tokens,
            faulted.prefill_rounds_by_rows) == clean
    assert clean[1] >= sum(n for n, _ in lens)
    assert clean[2] > clean[1]


def test_ranges_are_function_scope():
    """A span's range is no user annotation: the profiler echoes a user
    range (``record_function``) on the device timeline, from its first
    kernel to its last, and a span must add no device interval."""
    stats = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span(stats, spans.STEP):
            with span(stats, spans.REPLAY):
                torch.ones(2).add_(1)
        with torch.profiler.record_function("user.range"):
            torch.ones(2)
    kind = {e.name: e.is_user_annotation for e in prof.events()
            if e.name in (spans.STEP, spans.REPLAY, "user.range")}
    assert kind == {spans.STEP: False, spans.REPLAY: False,
                    "user.range": True}
    assert stats["step_s"] >= stats["replay_s"] > 0
