"""The host and counter arithmetic of the metric readers, the count of
refused submissions, and the sample that ``correct`` judges."""
from types import SimpleNamespace as Ctx

import numpy as np
import pytest

from portbench.run import read_metrics
from portbench.serve import Driver, Record, ReqStat
from portbench.traffic import Req


def _rec():
    rec = Record(seconds=10.0, window_s=10.5)
    rec.reqs[0] = ReqStat(submit=0.0, token_times=[1.4, 1.5, 1.6, 1.7])
    rec.reqs[1] = ReqStat(submit=0.0)                   # no token yet
    rec.reqs[2] = ReqStat(submit=2.0, token_times=[3.0])
    rec.step_walls = [0.010, 0.030]
    rec.pool_pages, rec.pool_peak_pages = 400, 96
    return rec


def test_readers_by_name():
    ctx = Ctx(rec=_rec(), setup_s=12.5, trace=None, shape=None, peaks={})
    defs = [{"name": n, "unit": u} for n, u in (
        ("setup_s", "s"), ("output_tokens_per_s", "tokens/s"),
        ("step_wall_ms.backlog", "ms"), ("kv_pool_used_peak", "%"),
        ("mfu.backlog", "%"), ("b1_roofline.backlog", "%"),
        ("b2_roofline.backlog", "%"), ("device_idle.backlog", "%"))]
    got = read_metrics(defs, ctx)
    assert got["setup_s"] == {"value": 12.5, "unit": "s"}
    assert got["output_tokens_per_s"]["value"] == pytest.approx(5 / 10.5)
    assert got["step_wall_ms.backlog"]["value"] == pytest.approx(20.0)
    assert got["kv_pool_used_peak"]["value"] == pytest.approx(24.0)
    # no device trace: the device readers return nothing and are left out
    assert set(got) == {"setup_s", "output_tokens_per_s",
                        "step_wall_ms.backlog", "kv_pool_used_peak"}


def test_no_steps_and_no_pool_read_nothing():
    rec = Record(seconds=1.0, window_s=1.0)
    ctx = Ctx(rec=rec, setup_s=1.0, trace=None, shape=None, peaks={})
    got = read_metrics([{"name": "step_wall_ms.backlog", "unit": "ms"},
                        {"name": "kv_pool_used_peak", "unit": "%"}], ctx)
    assert got == {}


class _Engine:
    """Just enough of an engine for ``Driver._submit``: it refuses a
    prompt longer than 8 tokens, as ``Engine.submit`` refuses one whose
    peak KV exceeds its context."""
    ecfg = Ctx(chunk=4, page_size=4)

    def __init__(self):
        self.taken = []

    def submit(self, r):
        if r.input_len > 8:
            raise ValueError(f"request {r.rid} peak KV > cache_len")
        self.taken.append(r.rid)


def test_refused_submissions_count_as_failed():
    reqs = [Req(rid=i, prompt=np.zeros(n, np.int32), output_len=2)
            for i, n in enumerate([4, 12, 8, 30])]
    drv = Driver(_Engine(), reqs, {"queue_depth": 4}, 1.0)
    for q in reqs:
        drv._submit(q, 0.25)
    assert drv.rec.attempted == 4 and drv.rec.failed == 2
    assert drv.eng.taken == [0, 2] and sorted(drv.rec.reqs) == [0, 2]
    assert drv.rec.reqs[2].submit == 0.25


def test_sample_keeps_the_longest_and_draws_from_the_seed():
    from portbench import check
    fin = {r: (np.zeros(4, np.int32), [0] * n)
           for r, n in enumerate([10, 900, 30, 200, 50, 40, 60, 70])}
    s = check.sample(fin, 5)
    assert s[0] == 1 and len(s) >= check.SAMPLE_MIN
    assert sum(len(fin[r][1]) for r in s) >= check.SAMPLE_TOKENS or \
        len(s) == len(fin)
    assert s == check.sample(fin, 5) and len(set(s)) == len(s)
    assert {tuple(check.sample(fin, k)) for k in range(6)} != {tuple(s)}
    assert check.sample({}, 5) == []


def test_control_is_judged_by_the_same_limits():
    from portbench import check
    reading = {"max_logit_gap": 0.05, "mean_logit_gap": 0.001,
               "served_tokens": 300, "requests": 4,
               "control_max_logit_gap": 0.9,
               "control_mean_logit_gap": 0.08}
    low = check.control_reading(reading)
    assert low == {"max_logit_gap": 0.9, "mean_logit_gap": 0.08,
                   "served_tokens": 300, "requests": 4}
    limits = {"limits": {"max_logit_gap": 0.32, "mean_logit_gap": 0.012}}
    assert check.verdict(reading, limits)[0]
    ok, checks = check.verdict(low, limits)
    assert not ok and checks["max_logit_gap"]["value"] == 0.9
