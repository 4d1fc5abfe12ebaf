"""The Qwen3-30B-A3B configuration and the grouped MoE layer's metric:
the file's keys through ``spec``, its sizes, and the ``moe_share`` reader
on a made-up trace (and on one without the kernels, as a program without
the grouped dispatch leaves it)."""
import json
import math
from types import SimpleNamespace

import pytest

from portbench.check import load_limits
from portbench.metrics import moe_share
from portbench.roofline import formulas as F
from portbench.serve import StepRec
from portbench.spec import ROOT, load_cell, shape_from_config
from portbench.trace import TraceData
from portbench.weights import leaf_specs

CELL = "qwen3-moe-30b-a3b.chat_backlog"


def conf():
    return json.loads((ROOT / "portbench" / "configs" /
                       "qwen3-moe-30b-a3b.json").read_text())


def test_config_keys_load_through_spec():
    m = shape_from_config(conf())
    assert (m.num_layers, m.d_model, m.num_heads, m.num_kv_heads,
            m.head_dim) == (48, 2048, 32, 4, 128)
    assert (m.num_experts, m.padded_experts, m.experts_per_token,
            m.moe_d_ff, m.num_shared_experts) == (128, 128, 8, 768, 0)
    assert m.qk_norm and not m.tie_embeddings and m.family == "moe"
    assert (m.vocab_size, m.max_context) == (151936, 40960)
    assert m.rope_theta == 1e6 and m.norm_eps == 1e-6
    assert m.kv_bytes_per_token() == 98304


def test_config_is_the_whole_model():
    c = conf()
    assert c["reduced"] == [] and c["engine"]["moe_impl"] == "grouped"
    assert c["engine"]["nslots"] == 128 and c["engine"]["plane"] == "paged"
    params = sum(math.prod(s)
                 for _, s, _ in leaf_specs(shape_from_config(c)))
    assert params == pytest.approx(30.5e9, rel=0.01)    # 61.1 GB in bf16


def test_cell_reads_both_new_metrics():
    cell = load_cell(CELL)
    assert cell.config["name"] == "qwen3-moe-30b-a3b"
    names = {m["name"] for m in cell.per_layer}
    assert {"moe_share.backlog", "b1_roofline.backlog",
            "mfu.backlog"} <= names
    assert [m["name"] for m in cell.end_to_end] == ["setup_s",
                                                    "output_tokens_per_s"]
    assert "mean_logit_gap" in load_limits(CELL)["limits"]


def fake_ctx(device, steps):
    m = shape_from_config(conf())
    trace = TraceData(window=(0.0, 1.0), device=device)
    rec = SimpleNamespace(steps=steps)
    return SimpleNamespace(shape=m, rec=rec, trace=trace,
                           peaks=F.peaks("NVIDIA H100 80GB HBM3"))


def test_share_on_a_trace():
    steps = [StepRec(decode_ctx=[100] * 128, rounds=[])] * 2
    dev = [("moe_grouped_route", 0.0, 0.01),
           ("moe_grouped_layout", 0.01, 0.02),
           ("moe_grouped_mm_gate_up", 0.02, 0.52),
           ("moe_grouped_mm_down", 0.52, 0.77),
           ("moe_grouped_combine", 0.77, 0.78),
           ("paged_decode_kernel", 0.78, 0.98)]
    assert moe_share.read(fake_ctx(dev, steps)) == pytest.approx(
        100 * 0.78 / 0.98)


def test_share_finds_nothing_without_the_kernels():
    """A program with no grouped dispatch (the parent): no value, no
    raise."""
    steps = [StepRec(decode_ctx=[100] * 32, rounds=[])]
    ctx = fake_ctx([("paged_decode_kernel", 0.0, 0.5),
                    ("nvjet_gemm", 0.5, 0.9)], steps)
    assert moe_share.read(ctx) is None
    ctx.trace = None
    assert moe_share.read(ctx) is None
