"""Layout adapter: the port's parameter tree (as ``portbench.weights``
makes it) to the reference's float32 tensors, one layer at a time.

The port stacks per-layer leaves on a leading ``L`` axis, keeps weights
``(in, out)`` and norm scales zero-centred (``x * (1 + scale)``); the
reference takes each layer's weights as ``(in, out)`` float32 matrices and
plain norm weights ``1 + scale``.  Only the benchmark's own tensors are
read: nothing the program derived from them.
"""
from __future__ import annotations

from typing import Dict

import torch


class PortWeights:
    def __init__(self, m, params: Dict, device=None):
        self.m, self.p = m, params
        self.device = device or params["embed"].device

    def _f(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, torch.float32)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self._f(self.p["embed"][tokens.to(self.p["embed"].device)])

    def final_norm(self) -> torch.Tensor:
        return 1.0 + self._f(self.p["ln_f"])

    def head(self) -> torch.Tensor:
        w = self.p["embed"] if self.m.tie_embeddings else self.p["head"]
        return self._f(w[:self.m.vocab_size])

    def layer(self, l: int) -> Dict[str, torch.Tensor]:
        L = self.p["layers"]
        a = L["attn"]
        W = {"ln1": 1.0 + self._f(L["ln1"][l]),
             "ln2": 1.0 + self._f(L["ln2"][l]),
             "wq": self._f(a["wq"][l]), "wk": self._f(a["wk"][l]),
             "wv": self._f(a["wv"][l]), "wo_attn": self._f(a["wo"][l])}
        if self.m.qk_norm:
            W["q_norm"] = 1.0 + self._f(a["q_norm"][l])
            W["k_norm"] = 1.0 + self._f(a["k_norm"][l])
        if self.m.num_experts:
            e = L["moe"]
            W.update(router=self._f(e["router"][l]),
                     e_wi_gate=self._f(e["wi_gate"][l]),
                     e_wi_up=self._f(e["wi_up"][l]),
                     e_wo=self._f(e["wo"][l]))
            if self.m.num_shared_experts:
                s = e["shared"]
                W.update(s_wi_gate=self._f(s["wi_gate"][l]),
                         s_wi_up=self._f(s["wi_up"][l]),
                         s_wo=self._f(s["wo"][l]),
                         shared_gate=self._f(e["shared_gate"][l]))
        else:
            mp = L["mlp"]
            W.update(wi_gate=self._f(mp["wi_gate"][l]),
                     wi_up=self._f(mp["wi_up"][l]), wo=self._f(mp["wo"][l]))
        return W
