"""Deterministic, sharded, infinite synthetic token pipeline (the port's
copy of ``repro.data.synthetic``: numpy only, batches identical to the
JAX package's).

Every (step, host) pair maps to the same tokens through a numpy
generator seeded with (seed, step, shard) — any host can recompute any
shard, so the data path has no single point of failure and straggling
hosts can be skipped and recomputed elsewhere.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # language-model-ish skew: zipf-like marginal over the vocabulary
    zipf_a: float = 1.2


def batch_for_step(cfg: DataConfig, step: int, *,
                   shard: int = 0, num_shards: int = 1) -> Dict[str, np.ndarray]:
    """The (tokens, labels) shard for ``step`` — pure function of
    (seed, step, shard)."""
    assert cfg.global_batch % num_shards == 0
    b = cfg.global_batch // num_shards
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))
    # zipf-ish skew, clipped into vocab
    raw = rng.zipf(cfg.zipf_a, size=(b, cfg.seq_len + 1))
    toks = (raw - 1) % cfg.vocab_size
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def data_iterator(cfg: DataConfig, *, start_step: int = 0, shard: int = 0,
                  num_shards: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_for_step(cfg, step, shard=shard, num_shards=num_shards)
        step += 1


def batch_with_frontend(model_cfg: ModelConfig, data_cfg: DataConfig,
                        step: int) -> Dict[str, np.ndarray]:
    """Adds the stub modality inputs (precomputed patch embeddings)."""
    batch = batch_for_step(data_cfg, step)
    if model_cfg.frontend == "patch":
        rng = np.random.default_rng(
            np.random.SeedSequence([data_cfg.seed, step, 999]))
        batch["patch_embeds"] = rng.standard_normal(
            (data_cfg.global_batch, model_cfg.num_patches,
             model_cfg.d_model)).astype(np.float32)
    return batch
