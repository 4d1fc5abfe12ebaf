"""How far two bf16 runs' greedy tokens may part: the fp32 logit margin at
the first output position where they differ, beside the error that bf16
arithmetic makes on the top logits where they agree.

Two bf16 runs of one model (two serving planes, or a plane and
``generate_reference``) round at different places, so a greedy token can
flip where the two best logits lie closer than that rounding.
``divergence_margins`` takes both runs' tokens for each request, finds
the first output position p where they differ, and prefills the prompt
plus the p shared tokens twice (``layer_states``' ``full`` path): in
fp32, with the run's bf16 weights cast to fp32 one layer at a time (so
no second copy of the weights is held), and in bf16.  It returns

* per request: p, the two tokens (this run's, then the other run's),
  their fp32 logit gap at p, and the bf16 spacing at the size of the
  top logit there (a bf16 logit is rounded to that step);
* the |bf16 - fp32| error of the fp32 top-``top`` logits at every output
  position before p (where the runs agree), pooled over the requests,
  and its 99th percentile.

A divergence whose fp32 gap is at most that percentile is a near-tie,
which bf16 rounding alone may flip; one above it is a fault to find.

``layer_states`` finds where a fault would start: the hidden state after
every layer of one request on the arithmetic of each serving path of the
dense family (the whole sequence at once as ``prefill`` runs it; the
prompt chunk by chunk into a slot cache, then one decode step per later
token, as the slot planes run it; the same over page pools through B2
and B1 as the paged plane runs it), to hold against the fp32 states
layer by layer.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.common import Params, rms_norm

#: the two kinds of divergence
NEAR_TIE, FAULT = "near-tie", "fault"


def _cast(tree, dtype):
    if dtype is None:
        return tree
    return {k: _cast(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def first_divergence(got: Sequence[int], want: Sequence[int]
                     ) -> Optional[int]:
    """The first output position where the two token lists differ (the
    shorter one's length if one is a prefix of the other), or None."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i
    return None if len(got) == len(want) else min(len(got), len(want))


def quantile(xs: Sequence[float], q: float) -> Optional[float]:
    """The q-quantile of ``xs`` (linear interpolation), None if empty."""
    if not len(xs):
        return None
    return torch.quantile(torch.tensor(list(xs), dtype=torch.float64),
                          q).item()


def bf16_spacing(x: float) -> float:
    """The gap between bf16 values next to ``x``: the step to which a bf16
    logit of that size is rounded (0.03125 for |x| in [4, 8))."""
    if x == 0.0:
        return torch.finfo(torch.bfloat16).tiny
    return torch.finfo(torch.bfloat16).eps * 2.0 ** math.floor(
        math.log2(abs(x)))


def classify(gap: float, err: Optional[float]) -> str:
    """A near-tie when the fp32 gap is at most the bf16 error ``err``."""
    return NEAR_TIE if err is not None and abs(gap) <= err else FAULT


def divergence_margins(cfg: ModelConfig, params: Params,
                       prompts: Mapping[int, Sequence[int]],
                       got: Mapping[int, Sequence[int]],
                       want: Mapping[int, Sequence[int]], *,
                       top: int = 2, moe_impl: str = "dense",
                       device: str = "cuda") -> Dict:
    """The margins of every request (rid in ``prompts``) whose ``got``
    tokens leave ``want``; ``cfg``/``params`` the bf16 model both runs
    served (the module docstring has what is measured)."""
    import dataclasses
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    reqs, errs = {}, []
    vocab = cfg.vocab_size
    for rid, prompt in prompts.items():
        p = first_divergence(got[rid], want[rid])
        if p is None or p >= min(len(got[rid]), len(want[rid])):
            continue
        a, b = got[rid][p], want[rid][p]
        toks = torch.tensor([list(prompt) + list(want[rid][:p])],
                            dtype=torch.long, device=device)
        n = len(prompt) - 1                  # predicts output 0
        with torch.no_grad():
            l32 = layer_states(cfg32, params, toks, dtype=torch.float32,
                               moe_impl=moe_impl)[1][n:, :vocab]
            l16 = layer_states(cfg, params, toks,
                               moe_impl=moe_impl)[1][n:, :vocab].float()
        gap = (l32[p, a] - l32[p, b]).item()
        ids = torch.topk(l32[:p], top, dim=-1).indices
        e = (torch.gather(l16[:p], 1, ids) - torch.gather(l32[:p], 1, ids))
        errs += e.abs().flatten().tolist()
        top2 = torch.topk(l32[p], 2)
        reqs[rid] = {"pos": p, "tokens": [a, b], "gap_fp32": gap,
                     "top2_fp32": top2.indices.tolist(),
                     "ulp_bf16": bf16_spacing(top2.values[0].item())}
    p99 = quantile(errs, 0.99)
    for r in reqs.values():
        r["kind"] = classify(r["gap_fp32"], p99)
    return {"requests": reqs, "err_p99": p99,
            "err_max": max(errs) if errs else None, "n_err": len(errs),
            "near_ties": sum(r["kind"] == NEAR_TIE for r in reqs.values()),
            "faults": sum(r["kind"] == FAULT for r in reqs.values())}


#: the serving paths of ``layer_states``
PATHS = ("full", "chunk", "paged")


def layer_states(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 path: str = "full", *, prompt_len: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None, chunk: int = 128,
                 page_size: int = 16, cache_len: Optional[int] = None,
                 impl: str = "reference", moe_impl: str = "dense"):
    """(the hidden state after each layer, (S, d) fp32 each; the logits
    (S, Vpad)) of one row ``tokens`` (1, S) on ``path``:

    * ``"full"``: ``prefill``'s blocks over the whole sequence
      (``impl="reference"``, so the last logits are ``prefill``'s; every
      family);
    * ``"chunk"``, the slot planes (dense family): the first
      ``prompt_len`` tokens (default all) prefilled ``chunk`` at a time
      through ``prefill_chunk``'s blocks into a slot cache of
      ``cache_len`` (default S rounded up to 64), then each later token
      decoded alone through ``decode_step``'s blocks with the decode
      attention ``impl`` (``"paged"``: B1 on the dense view);
    * ``"paged"``, the paged plane (dense family): the prompt prefilled
      through ``serving.paged_plane.prefill_layer`` (B2 over pools of
      ``page_size``), each later token through its ``decode_layer`` (B1).

    ``dtype`` (``"full"`` only) casts the weights to it as they are used,
    one layer at a time; ``cfg.dtype`` should name the same type."""
    from repro_torch.serving import paged_plane as pp
    if path not in PATHS:
        raise ValueError(f"path {path!r} not in {PATHS}")
    if dtype is not None and path != "full":
        raise ValueError("a cast runs on the full path only")
    top = _cast({k: v for k, v in params.items() if k != "layers"}, dtype)
    layers = M.unstack_layers(params)
    dev, S = tokens.device, tokens.shape[1]
    P = S if prompt_len is None or path == "full" else prompt_len
    spans = [(s, min(P, s + chunk)) for s in range(0, P, chunk)]
    spans = ([(0, S)] if path == "full"
             else spans + [(s, s + 1) for s in range(P, S)])
    states, last = [[] for _ in layers], []
    one = torch.ones(1, dtype=torch.int32, device=dev)
    if path == "chunk":
        cache = M.init_cache(cfg, 1, cache_len or -(-S // 64) * 64,
                             device=dev)
    elif path == "paged":
        npages = -(-S // page_size)
        kp, vp = pp.init_pools(cfg, npages, page_size, device=dev)
        bt = torch.arange(npages, dtype=torch.int32, device=dev)[None]
    for s0, s1 in spans:
        c, decode = s1 - s0, s0 >= P
        start = torch.tensor([s0], dtype=torch.int32, device=dev)
        pos = start[:, None] + torch.arange(c, dtype=torch.int32, device=dev)
        x, prefix_len = M._embed(cfg, top, tokens[:, s0:s1], pos)
        lcs = []
        for l, lp in enumerate(layers):
            lp = _cast(lp, dtype)        # one layer's copy at a time
            if path == "full":
                x, _ = M._block_full(cfg, lp, x, pos, prefix_len,
                                     "reference", moe_impl, 0)
            elif path == "chunk" and decode:
                x, lc = M._block_decode(
                    cfg, lp, x, {k: cache[k][l] for k in ("k", "v")},
                    start, impl, moe_impl)
                lcs.append(lc)
            elif path == "chunk":
                x, lc = M._block_chunk(
                    cfg, lp, x, {k: cache[k][l] for k in ("k", "v")},
                    start, "reference", moe_impl, None)
                lcs.append(lc)
            elif decode:
                ctx = start.long()
                x = pp.decode_layer(cfg, lp, x, ctx, ctx, kp[l], vp[l], bt,
                                    (ctx + 1).to(torch.int32), moe_impl)
            else:
                x = pp.prefill_layer(cfg, lp, x, pos, kp[l], vp[l], bt,
                                     start, c * one, moe_impl)
            states[l].append(x[0].float())
        last.append(x[0])
        if path == "chunk":
            cache = {**M._stack(lcs), "index": start + c}
    x = rms_norm(torch.cat(last), top["ln_f"], cfg.norm_eps)
    return [torch.cat(st) for st in states], M._logits(cfg, top, x)
