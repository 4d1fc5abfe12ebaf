"""The mix: deterministic per seed, the same work for every seed, and the
stated distributions."""
import hashlib

import numpy as np
import pytest

from portbench import traffic as T

VOCAB = 151936


def fingerprint(reqs) -> str:
    h = hashlib.sha256()
    for q in reqs:
        h.update(np.int64([q.rid, len(q.prompt), q.output_len]).tobytes())
        h.update(q.prompt.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed,digest", [
    (1, "8865b2dd713a589ae77e21812564fb0a965c758e9f41fada8ea2610f2096a42c"),
    (2 ** 31 + 11,
     "51d43a1b4ec54a28d21e5a1764ad904af30622bf730ff637bbb5153c30345a45"),
    (2 ** 40 + 3,
     "7bcb700bf07359117c006fa10a76f8bf702a13f6d8eef41f40934691682840e3"),
])
def test_backlog_requests_are_the_measured_ones(seed, digest):
    """The requests of each seed are those the cells' bounds and limits
    were measured on (sizes, order and token ids, bit for bit)."""
    reqs = T.make_requests(T.load_mix("chat_backlog"), seed, VOCAB)
    assert len(reqs) == 4096 and fingerprint(reqs) == digest


def test_backlog_is_deterministic_per_seed():
    mix = T.load_mix("chat_backlog")
    a = T.make_requests(mix, 2 ** 31 + 11, VOCAB)
    b = T.make_requests(mix, 2 ** 31 + 11, VOCAB)
    c = T.make_requests(mix, 5, VOCAB)
    assert fingerprint(a) == fingerprint(b) != fingerprint(c)


def test_every_seed_gets_the_same_work():
    mix = T.load_mix("chat_backlog")
    runs = [T.make_requests(mix, s, VOCAB) for s in (1, 2 ** 40 + 3)]
    key = (lambda q: (len(q.prompt), q.output_len))
    for lo in range(0, 640, mix["block"]):   # every block: one multiset
        blocks = [sorted(map(key, r[lo:lo + mix["block"]])) for r in runs]
        assert blocks[0] == blocks[1]
    assert [q.prompt.tolist() for q in runs[0][:5]] != \
        [q.prompt.tolist() for q in runs[1][:5]]


def test_backlog_distributions():
    mix = T.load_mix("chat_backlog")
    reqs = T.make_requests(mix, 4, VOCAB)
    assert len(reqs) == mix["count"]
    pl = [len(q.prompt) for q in reqs]
    ol = [q.output_len for q in reqs]
    assert min(pl) >= 64 and max(pl) <= 1024
    assert min(ol) >= 128 and max(ol) <= 1024
    assert abs(np.median(pl) - 256) <= 8 and abs(np.median(ol) - 320) <= 8
    # lognormal: the log-lengths' spread is sigma where nothing is clipped
    lp = np.log(pl)
    q16, q84 = np.percentile(lp, [16, 84])
    assert abs((q84 - q16) / 2 - 0.8) < 0.05
    assert T.max_context(mix) == 2048
    for q in reqs[:256]:
        assert q.prompt.dtype == np.int32 and q.prompt.max() < VOCAB


def test_stratified_quantiles():
    u = T.stratified({"dist": "uniform", "min": 0, "max": 100}, 4)
    assert u.tolist() == [12, 38, 62, 88]
    ln = T.stratified({"dist": "lognormal", "median": 100, "sigma": 0.5,
                       "min": 1, "max": 10_000}, 5)
    assert ln[2] == 100 and all(np.diff(ln) > 0)
    clipped = T.stratified({"dist": "lognormal", "median": 100,
                            "sigma": 3.0, "min": 50, "max": 200}, 6)
    assert clipped.min() == 50 and clipped.max() == 200
    with pytest.raises(ValueError):
        T.stratified({"dist": "pareto", "min": 1, "max": 2}, 3)


def test_shrink_divides_lengths():
    mix = T.shrink(T.load_mix("chat_backlog"), 16)
    assert mix["prompt_tokens"]["min"] == 4
    assert mix["prompt_tokens"]["max"] == 64
    assert mix["output_tokens"]["min"] == 8
    assert T.max_context(mix) == 128
    assert mix["count"] == T.load_mix("chat_backlog")["count"]


def test_unknown_mix_kind_is_refused(tmp_path, monkeypatch):
    (tmp_path / "odd.json").write_text('{"kind": "open"}')
    monkeypatch.setattr(T, "MIX_DIR", tmp_path)
    with pytest.raises(ValueError):
        T.load_mix("odd")


def test_each_run_of_requests_holds_the_mix():
    """Every seed puts the same work into every stretch of 8 requests: one
    request of each output-length octile and of each prompt-length
    octile."""
    mix = T.load_mix("chat_backlog")
    for seed in (1, 2 ** 40 + 3):
        r = T.make_requests(mix, seed, VOCAB)[:640]
        for b in range(0, 640, 64):
            for size in (lambda q: q.output_len, lambda q: len(q.prompt)):
                keys = np.array([size(q) for q in r[b:b + 64]])
                strata = np.array_split(np.sort(keys), T.STRATA)
                for a in range(0, 64, T.STRATA):
                    run = sorted(keys[a:a + T.STRATA])
                    assert all(s[0] <= v <= s[-1]
                               for s, v in zip(strata, run))
