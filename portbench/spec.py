"""What a run reads by name: the cell in ``BENCHMARK.json``, its model
configuration file, its mix and the metrics it reports.

``ModelShape`` is the configuration as the benchmark sees it, read from the
published ``config.json`` keys of ``portbench/configs/<name>.json`` and the
architectural facts the file states beside them; it
imports nothing of the port.  The port's ``ModelConfig`` is built from it in
``serve.py``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def pad_to(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


@dataclass(frozen=True)
class ModelShape:
    name: str
    family: str                 # dense | moe
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    qk_norm: bool
    rope_theta: float
    norm_eps: float
    tie_embeddings: bool
    max_context: int
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    vocab_pad_multiple: int = 256
    expert_pad_multiple: int = 16

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, self.vocab_pad_multiple)

    @property
    def padded_experts(self) -> int:
        return pad_to(self.num_experts, self.expert_pad_multiple) \
            if self.num_experts else 0

    @property
    def shared_d_ff(self) -> int:
        return self.num_shared_experts * self.moe_d_ff

    def kv_bytes_per_token(self, el: int = 2) -> int:
        return 2 * self.num_layers * self.kv_dim * el


def stated(c: Dict, key: str):
    """An architectural fact the configuration file has to state itself
    (the model's name never stands in for one)."""
    if key not in c:
        raise KeyError(f"configuration {c.get('name')!r} does not state "
                       f"{key!r}")
    return c[key]


def shape_from_config(c: Dict) -> ModelShape:
    """The published keys of a configuration file, and the facts it states
    beside them (``family``, ``qk_norm``) -> ModelShape."""
    d, H = c["hidden_size"], c["num_attention_heads"]
    moe = stated(c, "family") == "moe"
    return ModelShape(
        name=c["name"], family=c["family"],
        num_layers=c["num_hidden_layers"], d_model=d, num_heads=H,
        num_kv_heads=c["num_key_value_heads"],
        head_dim=c.get("head_dim") or d // H,
        d_ff=c["moe_intermediate_size"] if moe else c["intermediate_size"],
        vocab_size=c["vocab_size"], qk_norm=bool(stated(c, "qk_norm")),
        rope_theta=float(c["rope_theta"]), norm_eps=float(c["rms_norm_eps"]),
        tie_embeddings=bool(c["tie_word_embeddings"]),
        max_context=c["max_position_embeddings"],
        num_experts=c.get("num_experts", 0) if moe else 0,
        experts_per_token=c.get("num_experts_per_tok", 0) if moe else 0,
        moe_d_ff=c.get("moe_intermediate_size", 0) if moe else 0,
        num_shared_experts=(c["shared_expert_intermediate_size"]
                            // c["moe_intermediate_size"]) if moe else 0)


def small_shape(m: ModelShape) -> ModelShape:
    """A same-family shape small enough for the CPU tests (head size 64,
    the smallest the paged kernels take; GQA kept; a padded expert set)."""
    kw = dict(num_layers=2, d_model=64, num_heads=4,
              num_kv_heads=2 if m.num_kv_heads < m.num_heads else 4,
              head_dim=64, d_ff=128, vocab_size=512, vocab_pad_multiple=32)
    if m.num_experts:
        kw.update(num_experts=6, experts_per_token=2, moe_d_ff=32,
                  num_shared_experts=2, expert_pad_multiple=4)
    return replace(m, name=m.name + "-small", **kw)


def control_shape(m: ModelShape) -> ModelShape:
    """The control tests' shape: deeper, wider and with a larger
    vocabulary than ``small_shape``, and the published expert count and
    experts per token, so that the fp8 control departs at a size a CPU
    test holds."""
    kw = dict(num_layers=8, d_model=256, d_ff=512, vocab_size=65536)
    if m.num_experts:
        kw.update(num_experts=m.num_experts,
                  experts_per_token=m.experts_per_token, moe_d_ff=64,
                  expert_pad_multiple=m.expert_pad_multiple)
    return replace(small_shape(m), name=m.name + "-control", **kw)


@dataclass
class Cell:
    name: str
    config: Dict                # the configuration file
    shape: ModelShape
    traffic: str
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Optional[Path] = None) -> Cell:
    bench = json.loads((bench_path or BENCHMARK).read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    conf = json.loads((ROOT / cfgs[w["config"]]["file"]).read_text())
    return Cell(name=name, config=conf, shape=shape_from_config(conf),
                traffic=w["traffic"], chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])
