"""Serving launcher: ``python -m repro_torch.launch.serve [--full]``.

Runs the continuous-batching engine on a workload with the selected
scheduling / cache-replacement policy (the paper's deployment path) and
prints the §5.1 metrics.  A dense, MoE, VLM (``paligemma-3b``: text-only
requests) or audio (``musicgen-medium``) ``--arch`` runs on the paged
plane (the hand-written paged-attention kernels; MoE layers in the
engine's default dense dispatch); ``--arch rwkv6-7b`` on the
slot-resident plane (the hand-written WKV6 kernel), and so does ``--arch
hymba-1.5b`` (its sliding-window ring and SSM state are not paged).  Runs on ``--device
cuda`` (the default); ``--device cpu`` runs the kernels' plain PyTorch
versions.  Without ``--full`` the model is the config's ``reduced()``
variant (a dense one widened to 64-dim heads, the smallest head the
paged kernels take); weights are random, from ``--seed``.

``smoke_server`` builds the card's fixed smoke workload (full-width
TinyLlama-1.1B, a shared-prefix workload with registry hits and recompute
preemptions) that ``chip_smoke.py`` and ``scripts/profile_port_serve.py``
both serve, and serves the MoE smoke models (``SMOKE_MOE_ARCH``) the
same way; ``smoke_plane_server`` the same engine settings and workload
on another data plane (the dense slot-resident ``batched`` plane with a
decode ``impl`` and ``decode_append``, or the ``legacy`` plane);
``rwkv_smoke_server`` the RWKV6-7B one (8 requests of 60-300 prompt
tokens on 4 slots, with recompute or, given ``preempt_mode``, swap
preemptions; ``plane`` and ``decode_append`` as above);
``smoke_swap_server`` the swap one (TinyLlama-1.1B on Zipf-hot prompt
templates, with swap preemptions, tail sheds and the host demotion
tier); ``hybrid_smoke_server`` the hymba-1.5B one (8 requests of 127-3100
prompt tokens on 4 slots of a 2048-token sliding-window ring, which
prompts of 2030 tokens and more wrap in decode and the 3100-token one
in prefill, with recompute or, given ``preempt_mode``, swap preemptions;
``plane``, ``decode_append`` and the decode ``impl`` as above);
``audio_smoke_server`` the MusicGen-medium one (8 music prompts of
500-1500 codec tokens continued by 128, on 8 slots of the paged plane,
with recompute preemptions).
"""
from __future__ import annotations

import argparse
import logging
from dataclasses import replace

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import (Request, TheoreticalCostModel, get_hardware,
                              make_scheduler)
from repro_torch.data import (azureconv_like, fixed_grid, hetero_mix,
                              longform_like, shared_prefix,
                              zipf_shared_prefix)
from repro_torch.models import model as M
from repro_torch.serving import Engine, EngineConfig

log = logging.getLogger("repro_torch.serve")

WORKLOADS = {
    "fixed": lambda vocab: fixed_grid(12, 24, 8, vocab=vocab),
    "hetero": lambda vocab: hetero_mix(["SISO", "SILO"], 12, vocab=vocab),
    "azureconv": lambda vocab: azureconv_like(12, vocab=vocab),
    "longform": lambda vocab: longform_like(12, vocab=vocab),
    "shared_prefix": lambda vocab: shared_prefix(12, input_len=32,
                                                 output_len=8, vocab=vocab,
                                                 stagger=1e-6),
}

# the smoke workload: 16 requests of 256 prompt tokens (75 % shared in two
# groups) and 48 output tokens on 8 slots over a 2048-token KV budget
SMOKE_ARCH = "tinyllama-1.1b"
SMOKE_M = 2048                     # scheduler M: KV capacity in tokens
SMOKE_ENGINE = EngineConfig(nslots=8, cache_len=512, chunk=128,
                            page_size=16, plane="paged")
SMOKE_WORKLOAD = dict(n=16, input_len=256, prefix_frac=0.75, num_groups=2,
                      output_len=48, vocab=32000, stagger=1e-6, seed=0)


def smoke_server(cfg, params, device: str = "cuda",
                 moe_impl: str = "dense"):
    """A warmed ``Engine`` (vLLM scheduler, SRF replacement) and fresh
    requests of the smoke workload, for ``cfg``/``params`` of
    ``SMOKE_ARCH`` in any dtype, or of another model on the paged plane
    (``SMOKE_MOE_ARCH``, ``SMOKE_VLM_ARCH``: prompt ids drawn over its own
    vocabulary; an MoE model's layers in the ``moe_impl`` dispatch)."""
    sched = make_scheduler("vllm", SMOKE_M, S=SMOKE_ENGINE.cache_len,
                           replacement="srf")
    eng = Engine(cfg, params, sched, replace(SMOKE_ENGINE, moe_impl=moe_impl),
                 cost_model=TheoreticalCostModel(cfg, get_hardware("h100")),
                 device=device).warmup()
    return eng, shared_prefix(**dict(SMOKE_WORKLOAD, vocab=cfg.vocab_size))


def smoke_plane_server(cfg, params, device: str = "cuda",
                       plane: str = "batched", impl: str = "reference",
                       decode_append: str = "inline"):
    """``smoke_server``'s engine settings, scheduler and workload on the
    data plane ``plane`` (``"batched"``: the slot-resident cache with the
    decode attention ``impl`` and ``decode_append``; ``"legacy"``: the
    per-request exact-shape prefill), warmed; prompt ids over the model's
    vocabulary."""
    sched = make_scheduler("vllm", SMOKE_M, S=SMOKE_ENGINE.cache_len,
                           replacement="srf")
    eng = Engine(cfg, params, sched,
                 replace(SMOKE_ENGINE, plane=plane, impl=impl,
                         decode_append=decode_append),
                 cost_model=TheoreticalCostModel(cfg, get_hardware("h100")),
                 device=device).warmup()
    return eng, shared_prefix(**dict(SMOKE_WORKLOAD, vocab=cfg.vocab_size))


# the MoE smoke model: qwen2-moe (60 routed experts padded to 64, top-4,
# 4 shared; 16 q / 16 kv heads of 128) served by ``smoke_server``'s engine
# and workload with the engine's default dense dispatch; qwen3-moe (128
# experts, top-8, 32 q over 4 kv heads, qk-norm) is its second family
SMOKE_MOE_ARCH = "qwen2-moe-a2.7b"
SMOKE_MOE3_ARCH = "qwen3-moe-30b-a3b"

# the VLM smoke model: PaliGemma-3B's Gemma backbone (8 q / 1 kv heads of
# 256, a GELU MLP, sqrt(d)-scaled embeddings) served by ``smoke_server``'s
# engine and workload: text-only requests, as the JAX engine takes them
SMOKE_VLM_ARCH = "paligemma-3b"


# the RWKV6 smoke workload: 8 requests (one prompt of prime length, 127)
# of 32 output tokens on 4 slots, chunk 64, over an 800-token budget that
# forces recompute preemptions (2 on this schedule)
SMOKE_RWKV_ARCH = "rwkv6-7b"
SMOKE_RWKV_M = 800
SMOKE_RWKV_ENGINE = EngineConfig(nslots=4, cache_len=512, chunk=64,
                                 page_size=16, plane="batched")
SMOKE_RWKV_PROMPTS = (60, 127, 300, 200, 96, 256, 160, 72)
SMOKE_RWKV_OUTPUT = 32


def _fixed_requests(prompts, output_len: int, vocab: int, seed: int):
    """One request per prompt length, all arriving at 0, ids from a seed."""
    rs = np.random.RandomState(seed)
    return [Request(rid=i, input_len=n, output_len=output_len, arrival=0.0,
                    prompt=rs.randint(0, vocab, size=n).tolist())
            for i, n in enumerate(prompts)]


def rwkv_smoke_requests(vocab: int, seed: int = 0):
    return _fixed_requests(SMOKE_RWKV_PROMPTS, SMOKE_RWKV_OUTPUT, vocab, seed)


def rwkv_smoke_server(cfg, params, device: str = "cuda",
                      preempt_mode: str = "recompute", faults=None,
                      plane: str = "batched", decode_append: str = "inline"):
    """A warmed slot-plane ``Engine`` (vLLM scheduler, SRF replacement)
    and fresh requests of the RWKV6 smoke workload, for ``cfg``/``params``
    of ``SMOKE_RWKV_ARCH`` in any dtype (or depth); ``preempt_mode="swap"``
    suspends its victims' slots to the host instead of recomputing them,
    ``faults`` (a ``serving.faults.FaultSpec``) injects faults, and
    ``plane="legacy"`` / ``decode_append="deferred"`` pick those paths."""
    sched = make_scheduler("vllm", SMOKE_RWKV_M,
                           S=SMOKE_RWKV_ENGINE.cache_len, replacement="srf",
                           preempt_mode=preempt_mode)
    eng = Engine(cfg, params, sched,
                 replace(SMOKE_RWKV_ENGINE, faults=faults, plane=plane,
                         decode_append=decode_append),
                 cost_model=TheoreticalCostModel(cfg, get_hardware("h100")),
                 device=device).warmup()
    return eng, rwkv_smoke_requests(cfg.vocab_size)


# the hybrid smoke workload: hymba-1.5B (25 q / 5 kv heads of 64 over a
# 2048-token sliding-window ring, beside the selective SSM) on 4 slots,
# chunk 128; 8 requests of 48 output tokens whose prompts straddle the
# ring (2030-2049 wrap it while decoding, 3100 while prefilling), over a
# token budget that forces recompute preemptions (3 on this schedule);
# the scheduler's batch budget S holds the longest prompt whole
SMOKE_HYBRID_ARCH = "hymba-1.5b"
SMOKE_HYBRID_M = 4096
SMOKE_HYBRID_S = 4096
SMOKE_HYBRID_ENGINE = EngineConfig(nslots=4, cache_len=2048, chunk=128,
                                   plane="batched")
SMOKE_HYBRID_PROMPTS = (127, 640, 1900, 2030, 2047, 2048, 2049, 3100)
SMOKE_HYBRID_OUTPUT = 48


def hybrid_smoke_requests(vocab: int, seed: int = 0):
    return _fixed_requests(SMOKE_HYBRID_PROMPTS, SMOKE_HYBRID_OUTPUT, vocab,
                           seed)


def hybrid_smoke_server(cfg, params, device: str = "cuda",
                        preempt_mode: str = "recompute", faults=None,
                        plane: str = "batched", decode_append: str = "inline",
                        impl: str = "reference"):
    """A warmed slot-plane ``Engine`` (vLLM scheduler, SRF replacement)
    and fresh requests of the hybrid smoke workload, for
    ``cfg``/``params`` of ``SMOKE_HYBRID_ARCH`` in any dtype (or depth);
    ``preempt_mode``, ``faults``, ``plane`` and ``decode_append`` as in
    ``rwkv_smoke_server``, and ``impl="paged"`` runs the decode attention
    on the paged decode kernel over the ring."""
    sched = make_scheduler("vllm", SMOKE_HYBRID_M, S=SMOKE_HYBRID_S,
                           replacement="srf", preempt_mode=preempt_mode)
    eng = Engine(cfg, params, sched,
                 replace(SMOKE_HYBRID_ENGINE, faults=faults, plane=plane,
                         decode_append=decode_append, impl=impl),
                 cost_model=TheoreticalCostModel(cfg, get_hardware("h100")),
                 device=device).warmup()
    return eng, hybrid_smoke_requests(cfg.vocab_size)


# the audio smoke workload: MusicGen-medium (24 q / 24 kv heads of 64,
# sinusoidal positions) continuing 8 music prompts of 2.5-7.5 s of
# 4-codebook EnCodec codes at 50 Hz, flattened (200 tokens a second: 500-
# 1500 tokens), by 128 codes each (0.64 s), on 8 slots of the paged plane
# (page 16) over a KV budget that forces recompute preemptions (2 on this
# schedule); the scheduler's batch budget S holds the longest prompt whole
SMOKE_AUDIO_ARCH = "musicgen-medium"
SMOKE_AUDIO_M = 8192
SMOKE_AUDIO_S = 2048
SMOKE_AUDIO_ENGINE = EngineConfig(nslots=8, cache_len=2048, chunk=256,
                                  page_size=16, plane="paged")
SMOKE_AUDIO_SECONDS = (2.5, 7.5, 4.0, 6.0, 3.0, 5.5, 7.0, 4.5)
SMOKE_AUDIO_OUTPUT = 128


def audio_smoke_requests(vocab: int, seed: int = 0):
    return _fixed_requests([round(s * 200) for s in SMOKE_AUDIO_SECONDS],
                           SMOKE_AUDIO_OUTPUT, vocab, seed)


def audio_smoke_server(cfg, params, device: str = "cuda", **ekw):
    """A warmed paged-plane ``Engine`` (vLLM scheduler, SRF replacement)
    and fresh requests of the audio smoke workload, for ``cfg``/``params``
    of ``SMOKE_AUDIO_ARCH`` in any dtype (or depth); ``ekw`` overrides
    ``SMOKE_AUDIO_ENGINE``'s fields (``plane``, ``impl``, ...)."""
    sched = make_scheduler("vllm", SMOKE_AUDIO_M, S=SMOKE_AUDIO_S,
                           replacement="srf")
    eng = Engine(cfg, params, sched, replace(SMOKE_AUDIO_ENGINE, **ekw),
                 cost_model=TheoreticalCostModel(cfg, get_hardware("h100")),
                 device=device).warmup()
    return eng, audio_smoke_requests(cfg.vocab_size)


# the swap smoke workload: 32 requests on 8 Zipf-hot prompt templates
# (prefixes of 4-12 pages, hot ones short; arXiv 2403.05821's analytics
# traffic) of 256 prompt and 48 output tokens, on the smoke engine's 8
# slots and 2048-token budget: Sarathi chunked scheduling with page-level
# partial preemption, swap mode, and break-even replacement with the host
# demotion tier
SMOKE_SWAP_ENGINE = replace(SMOKE_ENGINE, cache_policy="break_even",
                            cache_demotion=True)
SMOKE_SWAP_WORKLOAD = dict(n=32, num_groups=8, page_size=16,
                           prefix_pages=(4, 12), input_len=256,
                           output_len=48, seed=3, vocab=32000)


def smoke_swap_server(cfg, params, device: str = "cuda",
                      preempt_mode: str = "swap", demotion: bool = True,
                      faults=None):
    """A warmed ``Engine`` (Sarathi-CS scheduler, SRF replacement, tail
    sheds) and fresh requests of the swap smoke workload, for
    ``cfg``/``params`` of ``SMOKE_ARCH`` in any dtype;
    ``preempt_mode="recompute", demotion=False`` is its no-host-traffic
    counterpart, and ``faults`` (a ``serving.faults.FaultSpec``) injects
    faults."""
    sched = make_scheduler("sarathi_cs", SMOKE_M, S=SMOKE_ENGINE.cache_len,
                           replacement="srf", preempt_mode=preempt_mode,
                           partial_preempt=True)
    eng = Engine(cfg, params, sched,
                 replace(SMOKE_SWAP_ENGINE, cache_demotion=demotion,
                         faults=faults),
                 cost_model=TheoreticalCostModel(cfg, get_hardware("h100")),
                 device=device).warmup()
    return eng, zipf_shared_prefix(**SMOKE_SWAP_WORKLOAD)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scheduler", default="vllm",
                    choices=["vllm", "vllm_hy", "sarathi", "sarathi_cs",
                             "orca", "vllm_pf", "sarathi_pf"])
    ap.add_argument("--replacement", default="srf",
                    choices=["nrf", "srf", "lrf", "pf"])
    ap.add_argument("--histogram", action="store_true",
                    help="SRF+Hist admission gating")
    ap.add_argument("--cache-policy", default="lru",
                    choices=["lru", "break_even"])
    ap.add_argument("--workload", default="fixed", choices=sorted(WORKLOADS))
    ap.add_argument("--M", type=int, default=128,
                    help="KV cache size in tokens")
    ap.add_argument("--nslots", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="the published widths instead of reduced()")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
        if cfg.family != "ssm":
            cfg = replace(cfg, head_dim=64)
    params = M.init_params(cfg, args.seed, device=args.device)
    reqs = WORKLOADS[args.workload](cfg.vocab_size)
    # crop requests to the engine's context budget
    for r in reqs:
        r.input_len = min(r.input_len, args.cache_len // 2)
        r.output_len = min(r.output_len, args.cache_len // 2)
        r.prompt = r.prompt[:r.input_len]

    sched = make_scheduler(args.scheduler, args.M, S=args.cache_len,
                           replacement=args.replacement,
                           use_histogram=args.histogram)
    cm = TheoreticalCostModel(cfg, get_hardware("h100"))
    eng = Engine(cfg, params, sched,
                 EngineConfig(nslots=args.nslots, cache_len=args.cache_len,
                              chunk=args.chunk, page_size=args.page_size,
                              plane="paged", cache_policy=args.cache_policy),
                 cost_model=cm, device=args.device)
    res = eng.run(reqs)
    s = res.metrics.summary()
    log.info("arch=%s device=%s scheduler=%s replacement=%s workload=%s",
             cfg.name, args.device, args.scheduler, args.replacement,
             args.workload)
    for k, v in s.items():
        log.info("  %-16s %.6g", k, v)
    log.info("wall time %.2fs; trie hits %d; sample output rid=0: %s",
             res.wall_time, res.swap_stats["trie_hits"],
             res.outputs.get(0, [])[:16])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
