"""Named spans over the serving step: host time by phase for operators,
and the same phases on the profiler's clock.

``with span(stats, name):`` times one phase of ``Engine.step``.  It always
adds the phase's inclusive host seconds to ``stats[KEY[name]]``
(``Engine.phase_stats``), so an operator gets the step's breakdown with
no profiler.  While a ``torch.profiler`` collects, it also opens a range
of that name, so the phase lies on the profiler's clock beside the
device's kernels and the host's operators, nested as the spans nest.

The range is a function-scope record (``_RecordFunctionFast``), not a
user-scope ``record_function``: the profiler gives a user-scope range a
device-side echo, an interval on the device timeline from the first to
the last kernel launched inside it, which a reader of device time would
count as work.  A function-scope range has none.

With the profiler off a span makes no call into it: it reads one flag
and the clock twice, a few microseconds at most, about a fifth of what
an unguarded ``record_function`` costs with no profiler running.  No
span is opened inside a captured step function: a range recorded at
capture does not replay.

Span names all start with ``PREFIX``.  A name's ``phase_stats`` key is
the name less the prefix, then ``_s`` (``engine.attach`` ->
``attach_s``).
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _profiler

PREFIX = "engine."

STEP = PREFIX + "step"                  # all of Engine.step, retries too
SCHEDULE = PREFIX + "schedule"          # sched.get_next_batch()
PREEMPT = PREFIX + "preempt"            # partial sheds, full preemptions
SWAP_IN = PREFIX + "swap_in"            # restores of re-admissions, tails
ATTACH = PREFIX + "attach"              # slot claims, attach, allocate
COMMIT = PREFIX + "commit"              # Engine._commit
PREFILL = PREFIX + "prefill"            # the prefill round loop
ROUND = PREFIX + "round"                # one prefill round
DECODE = PREFIX + "decode"              # the decode step
BLOCK_TABLES = PREFIX + "block_tables"  # a rebuild of the block tables
UPLOAD = PREFIX + "upload"              # a step graph's input upload
REPLAY = PREFIX + "replay"              # one step-graph call
FETCH = PREFIX + "fetch"                # the sampled-token fetch
ACCOUNT = PREFIX + "account"            # bookkeeping after compute
DRAIN = PREFIX + "drain"                # the step's swap drain

NAMES = (STEP, SCHEDULE, PREEMPT, SWAP_IN, ATTACH, COMMIT, PREFILL, ROUND,
         DECODE, BLOCK_TABLES, UPLOAD, REPLAY, FETCH, ACCOUNT, DRAIN)


#: span name -> its ``phase_stats`` key, made once
KEY: Dict[str, str] = {n: n[len(PREFIX):] + "_s" for n in NAMES}


class span:
    """Time one phase into ``stats``; a profiler range while one collects
    (see the module docstring)."""

    __slots__ = ("stats", "name", "rf", "t0")

    def __init__(self, stats: Dict[str, float], name: str):
        self.stats, self.name = stats, name
        self.rf: Optional[object] = None

    def __enter__(self) -> "span":
        if _profiler._is_profiler_enabled:
            self.rf = torch._C._profiler._RecordFunctionFast(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        k = KEY[self.name]
        # repro: allow-txn-coverage(phase_stats is measured wall-clock attribution - time an aborted attempt spent was still spent; parity never compares it)
        self.stats[k] = self.stats.get(k, 0.0) \
            + time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
        return False
