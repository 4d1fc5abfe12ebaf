"""Optimal scheduling as a constraint-satisfaction/optimization problem
(paper §7) — solved EXACTLY by uniform-cost search.

The paper encodes variables (s, m, c, g, e) per (request, batch) with
Big-M linearization and hands the MILP to Gurobi.  Gurobi is unavailable
offline, so this module solves the *same* constraint system by Dijkstra
over schedule states:

  state   = multiset of per-request (I, O, m, g)      [identical requests
            are interchangeable -> symmetry-reduced]
  edge    = one batch: per request an action from
            {skip, evict, run(c)} with c in {full remaining,
            crop-to-C-budget, crop-to-M-room}   [the paper's constraint
            (7) allows ANY c <= s - m; restricting to these break points
            preserves optimality for monotone cost models because any
            other chunk is dominated by one of them — a partial chunk
            neither generates a token nor frees memory earlier]
  cost    = cost_model.batch_time(batch)              [monotone, so
            Dijkstra's first settlement of the goal state is optimal]

Constraints enforced on every edge (paper's Termination, Memory
Management, Tokens-to-Process, Token Generation, Batch constraints):
  sum(c) <= C;  sum(m') <= M;  m' = 0 if evicted else m + c;
  g' = g + 1 iff c == (I + g) - m  (all remaining tokens processed);
  request finished when g == O (its KVs leave the cache: peak m = I+O-1).

Used by Fig. 13 (preemption can be optimal) and by "does a schedule
>= 10% better exist?" queries (``exists_schedule_below``).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import BatchSpec, CostModel
from repro_torch.core.invariants import invariant

# per-request key: (I, O, m, g)
ReqState = Tuple[int, int, int, int]
State = Tuple[ReqState, ...]

# an action applied to the request at a given state-index
#   ("run", c) | ("evict",) | ("skip",)
Action = Tuple


@dataclass
class CSPResult:
    optimal_time: float
    schedule: List[List[Tuple[ReqState, Action]]]
    num_batches: int
    num_preemptions: int
    states_expanded: int
    feasible: bool = True


def _initial_state(requests: Sequence[Tuple[int, int]]) -> State:
    return tuple(sorted((I, O, 0, 0) for I, O in requests))


def _is_goal(state: State) -> bool:
    return all(g >= O for (_, O, _, g) in state)


def _spec_of_actions(state: State, actions: Sequence[Action]) -> BatchSpec:
    spec = BatchSpec()
    for (I, O, m, g), act in zip(state, actions):
        if act[0] != "run":
            continue
        c = act[1]
        s = I + g
        if g > 0 and c == 1 and m == s - 1:
            spec.decodes.append((c, m))
        else:
            spec.prefills.append((c, m))
    return spec


def _apply(state: State, actions: Sequence[Action]) -> State:
    out = []
    for (I, O, m, g), act in zip(state, actions):
        if g >= O:                      # finished — stays finished
            out.append((I, O, 0, g))
            continue
        if act[0] == "evict":
            out.append((I, O, 0, g))
            continue
        if act[0] == "run":
            c = act[1]
            s = I + g
            m2 = m + c
            invariant(m2 <= s, (state, actions))
            if m2 == s:                 # token generated
                g2 = g + 1
                m2 = 0 if g2 >= O else m2   # completion frees memory
                out.append((I, O, m2, g2))
            else:
                out.append((I, O, m2, g))
            continue
        out.append((I, O, m, g))        # skip
    return tuple(sorted(out))


def _enumerate_batches(state: State, M: int, C: int,
                       max_actions_per_state: int = 200_000
                       ) -> List[Tuple[Action, ...]]:
    """All feasible per-request action tuples for one batch."""
    n = len(state)
    results: List[Tuple[Action, ...]] = []

    def rec(i: int, budget_c: int, mem_after: int, acc: List[Action]):
        if len(results) >= max_actions_per_state:
            return
        if i == n:
            # at least one request must run (empty batches are pointless)
            if any(a[0] == "run" for a in acc):
                results.append(tuple(acc))
            return
        I, O, m, g = state[i]
        if g >= O:                       # finished
            rec(i + 1, budget_c, mem_after, acc + [("skip",)])
            return
        remaining = (I + g) - m          # tokens still to process
        # candidate c values: full remaining, crop to batch budget,
        # crop to memory room (chunked prefill break points)
        mem_room = M - mem_after - m     # extra tokens this req may cache
        for c in {remaining, min(remaining, budget_c),
                  min(remaining, mem_room)}:
            if c <= 0 or c > budget_c:
                continue
            # memory after processing: m + c (cleared on completion)
            m2 = m + c
            if m2 > M - mem_after:
                continue
            gen = (m2 == I + g)
            freed = gen and (g + 1 >= O)
            hold = 0 if freed else m2
            rec(i + 1, budget_c - c, mem_after + hold, acc + [("run", c)])
        # skip (keep memory)
        if mem_after + m <= M:
            rec(i + 1, budget_c, mem_after + m, acc + [("skip",)])
        # evict (free memory) — only meaningful if it holds any
        if m > 0:
            rec(i + 1, budget_c, mem_after, acc + [("evict",)])

    rec(0, C, 0, [])
    return results


def solve_optimal_schedule(requests: Sequence[Tuple[int, int]], *,
                           M: int, C: int, cost_model: CostModel,
                           batch_time_bound: Optional[float] = None,
                           latency_bound: Optional[float] = None,
                           max_expansions: int = 2_000_000) -> CSPResult:
    """Uniform-cost search for the minimum-latency schedule.

    requests: [(I, O)] — offline (all arrive at t=0), as in Fig. 13.
    """
    start = _initial_state(requests)
    dist: Dict[State, float] = {start: 0.0}
    parent: Dict[State, Tuple[State, Tuple[Action, ...]]] = {}
    pq: List[Tuple[float, int, State]] = [(0.0, 0, start)]
    tie = itertools.count(1)
    expanded = 0

    goal: Optional[State] = None
    while pq:
        d, _, state = heapq.heappop(pq)
        if d > dist.get(state, float("inf")) + 1e-15:
            continue
        if latency_bound is not None and d > latency_bound:
            continue
        if _is_goal(state):
            goal = state
            break
        expanded += 1
        if expanded > max_expansions:
            raise RuntimeError("CSP search exceeded max_expansions")
        for actions in _enumerate_batches(state, M, C):
            spec = _spec_of_actions(state, actions)
            dt = cost_model.batch_time(spec)
            if batch_time_bound is not None and dt > batch_time_bound:
                continue
            nxt = _apply(state, actions)
            nd = d + dt
            if nd < dist.get(nxt, float("inf")) - 1e-15:
                dist[nxt] = nd
                parent[nxt] = (state, actions)
                heapq.heappush(pq, (nd, next(tie), nxt))

    if goal is None:
        return CSPResult(float("inf"), [], 0, 0, expanded, feasible=False)

    # reconstruct
    schedule: List[List[Tuple[ReqState, Action]]] = []
    preemptions = 0
    cur = goal
    while cur in parent:
        prev, actions = parent[cur]
        step = list(zip(prev, actions))
        preemptions += sum(1 for _, a in step if a[0] == "evict")
        schedule.append(step)
        cur = prev
    schedule.reverse()
    return CSPResult(optimal_time=dist[goal], schedule=schedule,
                     num_batches=len(schedule),
                     num_preemptions=preemptions,
                     states_expanded=expanded)


def exists_schedule_below(requests: Sequence[Tuple[int, int]], *, M: int,
                          C: int, cost_model: CostModel,
                          bound: float) -> bool:
    """Paper §7: 'validate whether a better schedule exists that could
    reduce the latency of current schedules by 10%' — existence query."""
    res = solve_optimal_schedule(requests, M=M, C=C, cost_model=cost_model,
                                 latency_bound=bound)
    return res.feasible and res.optimal_time < bound


def schedule_uses_preemption(result: CSPResult) -> bool:
    return result.num_preemptions > 0
