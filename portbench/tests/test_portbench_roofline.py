"""The frozen operation and byte counts against hand counts."""
import json

import pytest

from portbench.roofline import formulas as F
from portbench.spec import ROOT, shape_from_config


def shape(name):
    return shape_from_config(json.loads(
        (ROOT / "portbench" / "configs" / f"{name}.json").read_text()))


def test_b1_hand_count():
    m = shape("qwen3-4b")                 # H 32, Hkv 8, D 128
    ops, byt = F.b1_step(m, [100, 200])
    assert ops == 4 * 32 * 128 * 300
    assert byt == 2 * (2 * 8 * 128 * 300 + 2 * 32 * 128 * 2)


def test_shared_pages_count_once():
    m = shape("qwen3-4b")
    ops, byt = F.b1_step(m, [100, 200], kv_tokens=200)
    assert ops == 4 * 32 * 128 * 300               # every row computes
    assert byt == 2 * (2 * 8 * 128 * 200 + 2 * 32 * 128 * 2)
    rows = [(64, 16, 16, True), (64, 16, 16, True)]
    _, one = F.b2_round(m, rows, kv_tokens=64)      # one shared prefix
    _, two = F.b2_round(m, rows)
    assert two - one == 2 * 2 * 8 * 128 * 64


def test_b2_hand_count():
    m = shape("qwen3-4b")
    ops, byt = F.b2_round(m, [(0, 16, 16, True)])
    assert ops == 4 * 32 * 128 * (16 * 17 // 2)
    # k/v chunk read + written to the pool, q read + out written
    assert byt == 2 * (2 * 2 * 8 * 128 * 16 + 2 * 32 * 128 * 16)
    ops2, byt2 = F.b2_round(m, [(32, 16, 16, False)])
    assert ops2 - ops == 4 * 32 * 128 * 16 * 32    # 16 queries x 32 older keys
    assert byt2 - byt == 2 * 2 * 8 * 128 * 32      # the row's own pages


def test_model_ops_per_token():
    q = shape("qwen3-4b")
    per_layer = 2 * (2560 * (4096 + 2048) + 4096 * 2560 + 3 * 2560 * 9728)
    assert F.linear_ops_per_token(q) == per_layer
    assert per_layer * 36 + 2 * 2560 * 151936 == pytest.approx(8.04e9,
                                                                rel=1e-3)
    moe = shape("qwen2-moe-a2.7b")
    attn = 2048 * 3 * 2048 + 2048 * 2048
    experts = 4 * 3 * 2048 * 1408 + 3 * 2048 * 5632 + 2048 + 2048 * 60
    assert F.linear_ops_per_token(moe) == 2 * (attn + experts)


def test_step_ops_counts_useful_work_only():
    m = shape("qwen3-4b")
    lin = F.linear_ops_per_token(m) * 36
    att = 4 * 32 * 128 * 36
    head = 2 * 2560 * 151936
    got = F.step_ops(m, [10], [[(0, 4, 4, True), (8, 8, 0, False)]])
    assert got == pytest.approx((lin + att * 10 + head)
                                + (lin * 4 + att * (4 * 5 / 2) + head))
    # a recomputed chunk (no useful positions) adds nothing
    assert F.step_ops(m, [], [[(0, 8, 0, False)]]) == 0
    # a chunk whose last 2 of 4 positions are new: positions 6 and 7
    assert F.step_ops(m, [], [[(4, 4, 2, False)]]) == pytest.approx(
        lin * 2 + att * (7 + 8))


def test_least_time_and_peaks():
    p = F.peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_flops"] == 989e12 and p["hbm_bytes_per_s"] == 3.35e12
    assert F.least_time(989e12, 1.0, p["bf16_flops"], 3.35e12) == 1.0
    assert F.least_time(1.0, 3.35e12, p["bf16_flops"], 3.35e12) == 1.0
