"""``repro_torch.launch.margins`` on reduced configs on the CPU: the
logits it takes at every position are ``prefill``'s, the fp32 gap it
reports at a divergence is the gap of ``prefill`` over the prompt and the
shared tokens with the bf16 weights cast to fp32, the bf16 error is
pooled over the positions before it, and a divergence is a near-tie
exactly when its gap is within that error."""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import margins as mg
from repro_torch.models import model as M
from repro_torch.serving import generate_reference

ARCHS = ["tinyllama-1.1b", "qwen2-moe-a2.7b", "hymba-1.5b"]
PROMPT = list(range(3, 40))


def _bf16(name):
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="bfloat16")
    return cfg, M.init_params(cfg, 0, device="cpu")


@pytest.mark.parametrize("name", ARCHS)
def test_full_path_logits_are_prefills_at_every_position(name):
    cfg, params = _bf16(name)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    toks = torch.tensor([PROMPT])
    for c, kw, p in ((cfg32, {"dtype": torch.float32},
                      mg._cast(params, torch.float32)), (cfg, {}, params)):
        xs, full = mg.layer_states(c, params, toks, **kw)
        assert len(xs) == c.num_layers and full.shape[0] == len(PROMPT)
        assert xs[0].shape == (len(PROMPT), c.d_model)
        for n in (len(PROMPT), 20):
            last, _ = M.prefill(c, p, {"tokens": toks[:, :n]}, cache_len=64,
                                impl="reference", moe_impl="dense")
            torch.testing.assert_close(full[n - 1].float(),
                                       last[0].float(), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("path", ["chunk", "paged"])
def test_the_serving_paths_prefill_as_the_full_one(path):
    """On the CPU B2 runs its plain version, so every path's fp32 states
    are the full path's; the chunked paths cross a chunk boundary."""
    cfg, params = _bf16("tinyllama-1.1b")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = mg._cast(params, torch.float32)
    toks = torch.tensor([PROMPT])
    want_x, want = mg.layer_states(cfg32, p32, toks)
    got_x, got = mg.layer_states(cfg32, p32, toks, path, chunk=16,
                                 page_size=8)
    for a, b in zip(got_x, want_x):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        mg.layer_states(cfg32, params, toks, path, dtype=torch.float32)


@pytest.mark.parametrize("path,impl", [("chunk", "reference"),
                                       ("chunk", "paged"),
                                       ("paged", "reference")])
def test_the_serving_paths_decode_as_the_full_one(path, impl):
    """Past ``prompt_len`` every token is one decode step (on the CPU B1
    runs its plain version), and the fp32 states stay the full path's."""
    cfg, params = _bf16("tinyllama-1.1b")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = mg._cast(params, torch.float32)
    toks = torch.tensor([PROMPT])
    want_x, want = mg.layer_states(cfg32, p32, toks)
    got_x, got = mg.layer_states(cfg32, p32, toks, path, prompt_len=30,
                                 chunk=16, page_size=8, impl=impl)
    for a, b in zip(got_x, want_x):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_the_paged_path_runs_the_paged_planes_layers(monkeypatch):
    """The paged path calls the plane's own per-layer steps, once per
    layer and span: a change to the plane is a change to what it
    measures."""
    from repro_torch.serving import paged_plane as pp
    cfg, params = _bf16("tinyllama-1.1b")
    calls = {"prefill_layer": 0, "decode_layer": 0}
    for name in calls:
        fn = getattr(pp, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(pp, name, counted)
    mg.layer_states(cfg, params, torch.tensor([PROMPT]), "paged",
                    prompt_len=34, chunk=16, page_size=8)
    L = cfg.num_layers
    assert calls == {"prefill_layer": 3 * L, "decode_layer": 3 * L}


@pytest.mark.parametrize("name", ARCHS)
def test_a_divergence_gets_the_fp32_gap_of_its_two_tokens(name):
    cfg, params = _bf16(name)
    want = generate_reference(cfg, params, PROMPT, 8, cache_len=64,
                              device="cpu")
    p = 5
    got = list(want)
    got[p] = (want[p] + 1) % cfg.vocab_size
    got[p + 1:] = [0] * (len(got) - p - 1)
    out = mg.divergence_margins(cfg, params, {7: PROMPT, 8: PROMPT},
                                {7: got, 8: want}, {7: want, 8: want},
                                device="cpu")
    assert list(out["requests"]) == [7]          # rid 8 agrees throughout
    r = out["requests"][7]
    assert r["pos"] == p and r["tokens"] == [got[p], want[p]]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    last, _ = M.prefill(cfg32, mg._cast(params, torch.float32),
                        {"tokens": torch.tensor([PROMPT + want[:p]])},
                        cache_len=64, impl="reference", moe_impl="dense")
    gap = (last[0, got[p]] - last[0, want[p]]).item()
    assert r["gap_fp32"] == pytest.approx(gap, rel=1e-4, abs=1e-5)
    assert gap < 0      # fp32 prefers the greedy bf16 token here too
    assert out["n_err"] == 2 * p
    assert 0 < out["err_p99"] <= out["err_max"]
    assert r["kind"] == mg.classify(r["gap_fp32"], out["err_p99"])
    assert out["near_ties"] + out["faults"] == 1


def test_first_divergence_quantile_and_classify():
    assert mg.first_divergence([1, 2, 3], [1, 2, 3]) is None
    assert mg.first_divergence([1, 2, 3], [1, 5, 3]) == 1
    assert mg.first_divergence([1, 2], [1, 2, 3]) == 2
    assert mg.quantile([], 0.99) is None
    assert mg.quantile([0.0, 1.0], 0.5) == pytest.approx(0.5)
    assert mg.quantile(list(range(101)), 0.99) == pytest.approx(99.0)
    assert mg.classify(0.01, 0.02) == mg.NEAR_TIE
    assert mg.classify(-0.02, 0.02) == mg.NEAR_TIE
    assert mg.classify(0.03, 0.02) == mg.FAULT
    assert mg.classify(0.0, None) == mg.FAULT
    assert mg.bf16_spacing(5.0) == 0.03125 == mg.bf16_spacing(-7.9)
    assert mg.bf16_spacing(1.0) == 2.0 ** -7
    for x in (0.3, 3.7, 12.5, 40.0):       # the step to the next value
        b = torch.tensor(x, dtype=torch.bfloat16).float()
        step = mg.bf16_spacing(x)
        assert (b + step).to(torch.bfloat16).float() - b == step
        assert (b + step / 4).to(torch.bfloat16).float() == b


def _layer_script():
    import importlib.util
    from pathlib import Path
    path = (Path(__file__).resolve().parent.parent / "scripts"
            / "bf16_layer_errors.py")
    spec = importlib.util.spec_from_file_location("bf16_layer_errors", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_layer_script_takes_every_fault_of_the_report():
    """``scripts/bf16_layer_errors.py`` takes each fault once per (rid,
    position), with every plane that shows it and the paged plane's
    shared tokens; near-ties are left out, and planes that part before
    the position are refused."""
    lay = _layer_script()
    assert set(lay.PLANE_PATH.values()) <= set(lay.PATHS)
    assert {p for p, _ in lay.PATHS.values()} == set(mg.PATHS)

    def req(pos, kind, gap=0.05):
        return {"pos": pos, "kind": kind, "gap_fp32": gap}
    paged = {"0": [5, 6, 7], "1": [1, 2, 3]}
    report = {"serve_bf16": {"outputs": paged}, "planes_bf16": {
        "batched": {"outputs": {"0": [5, 9, 7], "1": [1, 2, 4]},
                    "margins": {"requests": {"0": req(1, "fault"),
                                             "1": req(2, "near-tie")}}},
        "legacy": {"outputs": {"0": [5, 9, 0], "1": [1, 2, 3]},
                   "margins": {"requests": {"0": req(1, "fault", 0.06)}}}}}
    got = lay.faults(report)
    assert list(got) == [(0, 1)]
    f = got[(0, 1)]
    assert f["planes"] == ["batched", "legacy"] and f["shared"] == [5]
    assert f["tokens"] == {"paged": 6, "batched": 9, "legacy": 9}
    assert f["gap_fp32"] == {"batched": 0.05, "legacy": 0.06}
    report["planes_bf16"]["legacy"]["outputs"]["0"] = [4, 9, 0]
    with pytest.raises(ValueError):
        lay.faults(report)

