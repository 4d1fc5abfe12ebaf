"""The float32 reference and its layout adapter against the port's own
model functions (``repro_torch.models.model.prefill``) at a small size."""
import json

import pytest
import torch

from portbench.reference import model as ref
from portbench.reference.adapter import PortWeights
from portbench.serve import port_model_config
from portbench.spec import ROOT, shape_from_config, small_shape
from portbench.weights import leaf_specs, make_params


def small(name):
    return small_shape(shape_from_config(json.loads(
        (ROOT / "portbench" / "configs" / f"{name}.json").read_text())))


@pytest.mark.parametrize("name", ["qwen3-4b", "qwen2-moe-a2.7b"])
def test_reference_matches_the_port_in_fp32(name):
    from repro_torch.models import model as M
    m = small(name)
    params = make_params(m, 1234, "cpu", torch.float32)
    cfg = port_model_config(m, "float32")
    toks = torch.randint(0, m.vocab_size, (1, 40),
                         generator=torch.Generator().manual_seed(5))
    picks = [6, 21, 39]
    got = ref.logits_at(m, PortWeights(m, params), [toks[0]],
                        [torch.tensor(picks)])[0]
    for row, p in zip(got, picks):
        want, _ = M.prefill(cfg, params, {"tokens": toks[:, :p + 1]},
                            cache_len=64, impl="reference",
                            moe_impl="dense")
        want = want[0, :m.vocab_size]
        assert torch.allclose(row, want, atol=2e-4, rtol=1e-4), \
            (p, (row - want).abs().max())
    assert float(got.std()) > 0.3          # logits of order one


@pytest.mark.parametrize("name", ["qwen3-4b", "qwen2-moe-a2.7b"])
def test_fp8_control_departs(name):
    m = small(name)
    params = make_params(m, 99, "cpu", torch.float32)
    w = PortWeights(m, params)
    seq = torch.randint(0, m.vocab_size, (48,),
                        generator=torch.Generator().manual_seed(1))
    pick = torch.arange(48)
    hi = ref.logits_at(m, w, [seq], [pick])[0]
    lo = ref.logits_at(m, w, [seq], [pick], quant="fp8")[0]
    err = (hi - lo).abs().max()
    assert 1e-3 < err < 10


def test_weights_layout_and_determinism():
    m = small("qwen2-moe-a2.7b")
    a = make_params(m, 7, "cpu", torch.bfloat16)
    b = make_params(m, 7, "cpu", torch.bfloat16)
    assert torch.equal(a["layers"]["moe"]["wi_gate"],
                       b["layers"]["moe"]["wi_gate"])
    assert a["layers"]["moe"]["wi_gate"].shape == (2, 8, 64, 32)
    assert a["embed"].shape == (512, 64) and "head" in a
    assert not torch.equal(a["layers"]["ln1"],
                           make_params(m, 8, "cpu", torch.bfloat16)
                           ["layers"]["ln1"])
    assert sorted(t.shape for t in _leaves(a)) == sorted(
        s for _, s, _ in leaf_specs(m))
    q = small("qwen3-4b")
    assert "head" not in make_params(q, 7, "cpu", torch.bfloat16)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _conf(name):
    return json.loads(
        (ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def test_qk_norm_is_read_from_the_file_not_the_name():
    """Both sides take qk-norm from the configuration file's own key: a
    file that does not state it is refused, and a Qwen3-MoE-style file
    (model_type ``qwen3_moe``) keeps qk-norm where it states it."""
    assert shape_from_config(_conf("qwen3-4b")).qk_norm
    assert not shape_from_config(_conf("qwen2-moe-a2.7b")).qk_norm
    c = _conf("qwen3-4b")
    del c["qk_norm"]
    with pytest.raises(KeyError, match="qk_norm"):
        shape_from_config(c)
    c = _conf("qwen2-moe-a2.7b")
    c.update(model_type="qwen3_moe", qk_norm=True)
    assert shape_from_config(c).qk_norm


def test_reference_applies_qk_norm_where_stated():
    """The reference's qk-norm is live: the same weights with the
    shape's qk_norm switched off give other logits."""
    from dataclasses import replace
    m = small("qwen3-4b")
    params = make_params(m, 3, "cpu", torch.float32)
    seq = torch.randint(0, m.vocab_size, (24,),
                        generator=torch.Generator().manual_seed(2))
    pick = [torch.arange(24)]
    on = ref.logits_at(m, PortWeights(m, params), [seq], pick)[0]
    off_m = replace(m, qk_norm=False)
    off = ref.logits_at(off_m, PortWeights(off_m, params), [seq], pick)[0]
    assert (on - off).abs().max() > 1e-2
