"""Inference request state machine (paper §3, Table 1).

Bookkeeping invariants (checked by property tests):
  * ``m``          — processed tokens currently held in the KV cache
  * ``generated``  — output tokens produced so far
  * target context = I + generated  (refill reprocesses generated tokens)
  * a token is generated exactly when m reaches I + generated
  * peak KV usage  = I + O - 1  (the O-th token is never cached)
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core.invariants import invariant


class Phase(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"   # running, still processing prompt (or refill)
    DECODE = "decode"     # running, generating
    FINISHED = "finished"


@dataclass
class Request:
    rid: int
    input_len: int                     # I
    output_len: int                    # O — ground truth; ONLY hypothetical
    #                                    schedulers / the simulator read it.
    arrival: float = 0.0
    prompt: Optional[List[int]] = None  # real token ids (engine mode)

    # --- dynamic state ---
    m: int = 0
    generated: int = 0
    running: bool = False
    preemptions: int = 0
    # --- swap/suspend state (§5.4) ---
    # A swap-preempted request keeps its KVs in HOST memory instead of
    # discarding them: ``suspended_m`` KVs are held by the swap store and
    # restored on re-admission, so no refill prefill is needed.
    suspended: bool = False
    suspended_m: int = 0
    swaps: int = 0
    # --- page-level partial preemption (§8 at sub-request granularity) ---
    # Under memory pressure a paged scheduler may shed only the victim's
    # TAIL pages instead of the whole request: ``tail_suspended_m`` tail
    # tokens live in the host store (page runs) and are restored before
    # the request's next compute step; a recompute-mode shed simply
    # lowers ``m`` to the kept page boundary and the tokens rejoin
    # ``remaining_prefill``.
    tail_suspended_m: int = 0
    partial_preemptions: int = 0
    # tokens that must cross the host link for the CURRENT full suspend
    # (the device-resident portion only: tail runs shed earlier were
    # already charged when they left) — drivers price swap-out with this,
    # and swap-in with ``suspended_m`` (everything comes back).
    swap_out_m: int = 0
    # --- metrics ---
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: List[float] = field(default_factory=list)
    # --- SRF+Hist bookkeeping ---
    predicted_output: Optional[float] = None

    # ------------------------------------------------------------------ #
    @property
    def target_context(self) -> int:
        """Tokens that must be in cache before the next token can emerge."""
        return self.input_len + self.generated

    @property
    def resident_kv(self) -> int:
        """KVs this request will hold on-device once (re)admitted, before
        processing: swapped-out KVs count — they are restored, not
        recomputed — so schedulers reserve for them and drivers skip the
        refill.  Suspended TAIL pages count too: they come back on-device
        before the request's next compute step."""
        if self.suspended:
            return self.suspended_m
        return self.m + self.tail_suspended_m

    @property
    def device_kv(self) -> int:
        """KVs physically on-device RIGHT NOW (idle reservation): a
        tail-suspended request holds only its kept prefix until the
        driver restores the tail at its next batch."""
        return 0 if self.suspended else self.m

    @property
    def remaining_prefill(self) -> int:
        return max(0, self.target_context - self.resident_kv)

    @property
    def phase(self) -> Phase:
        if self.finished:
            return Phase.FINISHED
        if not self.running:
            return Phase.WAITING
        # decode = only the last generated token remains to process
        if self.generated > 0 and self.remaining_prefill <= 1:
            return Phase.DECODE
        return Phase.PREFILL

    @property
    def finished(self) -> bool:
        return self.generated >= self.output_len

    @property
    def peak_kv(self) -> int:
        return self.input_len + self.output_len - 1

    # ------------------------------------------------------------------ #
    def advance(self, c: int, now: float) -> bool:
        """Process c tokens; returns True if a token was generated."""
        invariant(self.running and c >= 1, (self.rid, self.running, c))
        invariant(self.m + c <= self.target_context, "over-processing")
        self.m += c
        if self.m == self.target_context:
            # prefill completed, or decode step -> one new token
            self.generated += 1
            self.token_times.append(now)
            if self.first_token_time is None:
                self.first_token_time = now
            if self.finished:
                self.finish_time = now
                self.running = False
                self.m = 0
            return True
        return False

    def preempt(self, mode: str = "recompute") -> int:
        """Evict all device KVs; back to waiting. Returns tokens released.

        ``mode="swap"`` marks the KVs as suspended to host memory (§5.4):
        the driver must snapshot them before reusing the slot and restore
        them via :meth:`resume` on re-admission.  ``mode="recompute"``
        discards them (the §3 refill pays a full re-prefill).  A request
        with no cached KVs has nothing to swap and falls back to discard.

        Pending tail runs fold into the full suspend: a swap-mode full
        preemption keeps them in the host store (``suspended_m`` covers
        device + tail tokens); a recompute-mode one discards everything
        (the driver must drop the stored runs).
        """
        if mode not in ("recompute", "swap"):
            raise ValueError(f"preempt mode={mode!r}")
        released = self.m
        if mode == "swap" and self.m + self.tail_suspended_m > 0:
            self.suspended = True
            self.suspended_m = self.m + self.tail_suspended_m
            self.swap_out_m = self.m
            self.swaps += 1
        else:
            self.suspended = False
            self.suspended_m = 0
            self.swap_out_m = 0
        self.tail_suspended_m = 0
        self.m = 0
        self.running = False
        self.preemptions += 1
        return released

    # --- page-level partial preemption ---------------------------------- #
    def partial_preempt(self, n_tokens: int, mode: str = "recompute") -> int:
        """Shed ``n_tokens`` TAIL tokens (whole pages) under memory
        pressure; the request KEEPS its slot and stays running.
        ``mode="swap"`` sends the run to host memory (restored before the
        next compute step); ``mode="recompute"`` re-prefills the tokens
        later.  Returns the tokens shed."""
        if mode not in ("recompute", "swap"):
            raise ValueError(f"partial_preempt mode={mode!r}")
        invariant(self.running and 0 < n_tokens <= self.m,
                  (self.rid, self.running, n_tokens, self.m))
        self.m -= n_tokens
        self.partial_preemptions += 1
        if mode == "swap":
            self.tail_suspended_m += n_tokens
            self.swaps += 1
        return n_tokens

    def resume_tail(self) -> int:
        """Tail swap-in: the driver restored the suspended tail pages.
        Returns the number of restored tokens."""
        invariant(self.tail_suspended_m > 0, self.rid)
        restored = self.tail_suspended_m
        self.m += restored
        self.tail_suspended_m = 0
        return restored

    def drop_tail_run(self, n_tokens: int) -> None:
        """The driver could not keep a tail run (host store full): those
        tokens fall back to recompute via ``remaining_prefill``."""
        invariant(0 < n_tokens <= self.tail_suspended_m,
                  (self.rid, n_tokens, self.tail_suspended_m))
        self.tail_suspended_m -= n_tokens
        self.swaps -= 1

    def drop_suspended(self) -> None:
        """The driver could not keep the snapshot (host store full): this
        preemption falls back to discard-and-recompute — the request pays
        the full §3 refill on re-admission after all."""
        invariant(self.suspended, self.rid)
        self.suspended = False
        self.suspended_m = 0
        self.swaps -= 1

    def resume(self) -> int:
        """Swap-in: the driver restored ``suspended_m`` KVs to the device.
        Returns the number of restored tokens."""
        invariant(self.suspended, self.rid)
        restored = self.suspended_m
        self.m = restored
        self.suspended = False
        self.suspended_m = 0
        return restored

    # --- metrics helpers ------------------------------------------------ #
    def latency(self) -> Optional[float]:
        return None if self.finish_time is None else self.finish_time - self.arrival

    def ttft(self) -> Optional[float]:
        return (None if self.first_token_time is None
                else self.first_token_time - self.arrival)

    def tpot(self) -> Optional[float]:
        if self.finish_time is None or len(self.token_times) < 2:
            return None
        return ((self.token_times[-1] - self.token_times[0])
                / (len(self.token_times) - 1))
