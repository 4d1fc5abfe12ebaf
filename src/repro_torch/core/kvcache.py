"""Paged KV-cache block allocator (control plane) + radix-trie prefix
registry.

vLLM-style paging, now REAL: under ``EngineConfig.plane="paged"`` the
serving engine stores attention KV in shared per-layer page pools
``(num_pages, page_size, Hkv, D)`` and this allocator's block tables ARE
the physical page map those pools are indexed with (the Pallas paged
decode kernel dereferences them via scalar prefetch).  The allocator
enforces exactly the page-rounded ``sum(m) <= M`` constraint the
scheduler reasons about — control plane and data plane agree
page-for-page by construction.

Beyond plain bookkeeping it owns the two mechanisms contiguous slots
could never express:

* **Refcounted pages + copy-on-write** — a physical page may appear in
  several block tables (shared-prefix reuse) and/or be pinned by the
  prefix registry.  Writers must call :meth:`ensure_private` first; it
  transparently remaps a shared page to a fresh private one (the caller
  copies the pool contents).
* **Partial free** — :meth:`free_tail` releases only a request's tail
  pages (page-level partial preemption, the §8 replacement idea pushed
  to sub-request granularity).

**The registry is a token-level radix trie** (:class:`RadixPrefixRegistry`,
SGLang/Mooncake-style).  Each trie node owns a page-aligned RUN of
pages — per page a chained content digest (:func:`chain_keys`), the
page's token ids, and its chain depth ``n_kvs``.  ``lookup_run`` walks
root-to-leaf in O(L), re-verifying token ids at every node, and returns
the LONGEST matching prefix: a request sharing only a system prompt or
the first turns of a conversation reuses exactly those pages (partial
hit), where the old exact-chain registry would have reused nothing.  A
digest collision is verified away and degrades to a miss — never to
another prompt's KV (the token-identical contract).  When a query
diverges inside a node's run, the node is SPLIT at the (page-aligned)
divergence point, so hot front runs and cold tails get separate
replacement entries; when an eviction leaves a parent with a single
child, the pair is MERGED back into one run (path compression).

Every registered page holds a +1 pin so completed requests leave their
prompt pages behind as a cached prefix tree.  Pinned-only pages are
RECLAIMABLE: when the free list runs short, :meth:`PagedAllocator._take`
walks trie NODES in the eviction order of a PLUGGABLE
``policies.ReplacementPolicy`` (``lru``, ``break_even`` — the §6
five-minute rule, Eq. 5 break-even residency vs observed idle scored
with the node's END depth ``n_kvs``, so deep cold tails rank first — or
``belady-oracle`` for offline ablation).  The order is LEAF-FIRST and
pages evict from each node's TAIL: an evicted interior node can never
strand live descendants, and device residency stays prefix-closed along
every chain.  Nodes with a still-table-mapped tail page are SKIPPED
(evicting them frees nothing) and counted in
``stats["reclaim_skipped"]``; cached prefixes therefore never reduce the
capacity the scheduler may promise — ``OutOfPagesError`` stays
unreachable on admitted schedules.

Per-node refcounts are DERIVED, not stored: a node's refcount is the
number of live block-table mappings over its pages, read through the
allocator's page refcounts (``node_refs``).  One source of truth means
splits, merges, and transaction rollbacks can never desynchronize
lease bookkeeping from physical reality.

Eviction feeds an optional ``on_evict`` hook BEFORE each page returns to
the free list: drivers use it to DEMOTE the evicted KV to a host tier
(``serving.swap_store.PrefixPageEntry``).  A node's tail run demotes as
consecutive page-granular entries, each CRC-sealed; a later trie miss
that hits the host tier PROMOTES pages back through
:meth:`promote_prefix` (one fresh page, re-pinned, re-inserted at its
trie position) — :func:`attach_prefix_run` implements that two-tier
lookup for both the serving engine (real pool copies) and the
simulator's virtual-time shadow, so every KV access resolves along the
Fig. 8 spectrum: GPU-resident < host swap-in < recompute.

Replacement policy for REQUESTS is still not here — preemption victims
are chosen by ``repro.core.policies``; the engine then calls
``free(rid)`` / ``free_tail(rid, k)``.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Set, Tuple)

from repro_torch.core.invariants import invariant
from repro_torch.core.policies import LRUPolicy, ReplacementPolicy
from repro_torch.core import stat_keys as SK


class OutOfPagesError(RuntimeError):
    pass


@dataclass
class BlockTable:
    pages: List[int] = field(default_factory=list)
    num_tokens: int = 0  # valid tokens across those pages


def chain_keys(tokens: Sequence[int], page_size: int) -> List[int]:
    """Chained content digests for every FULL page of ``tokens``.

    Key ``i`` is a blake2b digest over (key ``i-1``, the token ids of
    page ``i``), so key ``i`` identifies the whole prefix through page
    ``i`` — and, unlike the builtin ``hash`` chain it replaced, the
    value is STABLE across processes and ``PYTHONHASHSEED`` settings
    (a prerequisite for ever persisting the prefix store, and for
    reproducible fault-plan draws keyed on these values)."""
    keys: List[int] = []
    prev = b""
    for i in range(len(tokens) // page_size):
        page = tokens[i * page_size:(i + 1) * page_size]
        h = hashlib.blake2b(prev, digest_size=8)
        h.update(b",".join(b"%d" % int(t) for t in page))
        prev = h.digest()
        keys.append(int.from_bytes(prev, "big"))
    return keys


class _TrieNode:
    """One radix-trie node: a page-aligned run of registered pages.

    Parallel lists (one slot per owned page): ``keys`` (chained content
    digests), ``pages`` (physical page ids), ``tokens`` (that page's
    token ids, for collision re-verification), ``nkvs`` (chain depth in
    tokens at that page — the Eq. 5 ``n_kvs`` input).  ``children`` maps
    a child's FIRST chain key to the child node; the node's own id is
    its first chain key (stable under tail shrink)."""

    __slots__ = ("parent", "children", "keys", "pages", "tokens", "nkvs")

    def __init__(self, parent: Optional["_TrieNode"]) -> None:
        self.parent = parent
        self.children: Dict[int, "_TrieNode"] = {}
        self.keys: List[int] = []
        self.pages: List[int] = []
        self.tokens: List[Tuple[int, ...]] = []
        self.nkvs: List[int] = []

    @property
    def node_id(self) -> int:
        return self.keys[0]

    def __repr__(self) -> str:  # debugging aid only
        return (f"_TrieNode(pages={self.pages}, "
                f"children={len(self.children)})")


class RadixPrefixRegistry:
    """Radix trie mapping chained page digests -> physical pages, with a
    pluggable node-level replacement policy.

    Structure: the root owns no pages; every other node owns a non-empty
    page run.  A node's policy entry is keyed by its ``node_id`` (first
    chain key) and scored with its END-depth ``n_kvs`` — the §6
    break-even policy therefore prices a node by the regeneration cost
    of its deepest page, which falls with depth, so long cold tails
    evict first.  Per-node refcounts are derived from the owning
    allocator's page refcounts via the ``live`` callable
    (:meth:`node_refs`); the registry itself never stores a lease.

    Key operations:

    * :meth:`lookup_run` — longest-prefix match in O(L) with token-id
      re-verification at every node; splits a partially-matched node at
      the page-aligned divergence point (``num_splits``).
    * :meth:`insert` — place one page after ``prev_key`` (its chain
      predecessor): extends the predecessor's leaf run in place, or
      starts a new child node (splitting the predecessor's node when
      the insertion point is mid-run).
    * :meth:`evict_tail` — pop a LEAF node's last page; an emptied node
      is unlinked, and a parent left with a single child is merged back
      into one run (``num_merges``).
    * :meth:`snapshot_state` / :meth:`restore_state` — structural
      deep-copy for step-transaction rollback (``serving.txn``); node
      refcounts need no snapshot because they are derived.

    Digest collisions: ``get``/``lookup_run`` compare the stored token
    ids and treat any mismatch as a MISS — a collision must never map
    another prompt's KV pages into a request.
    """

    def __init__(self, policy: Optional[ReplacementPolicy] = None,
                 live: Optional[Callable[[int], int]] = None) -> None:
        self.policy = policy if policy is not None else LRUPolicy()
        # page -> total refcount in the owning allocator (pin + tables);
        # standalone registries default to pin-only (no table mappings)
        self._live = live if live is not None else (lambda page: 1)
        self.root = _TrieNode(None)
        self._index: Dict[int, _TrieNode] = {}   # every key -> owning node
        self._count = 0                          # registered pages
        self.num_splits = 0
        self.num_merges = 0

    # --- size / membership --------------------------------------------- #
    def __len__(self) -> int:
        """Number of registered PAGES (not nodes)."""
        return self._count

    def __contains__(self, key: int) -> bool:
        return key in self._index

    @property
    def num_nodes(self) -> int:
        return len(set(map(id, self._index.values())))

    def nodes(self) -> Iterator[_TrieNode]:
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def node(self, node_id: int) -> Optional[_TrieNode]:
        """The node whose FIRST page is keyed ``node_id`` (None if the
        key is unregistered or mid-run — e.g. after a merge)."""
        n = self._index.get(node_id)
        return n if n is not None and n.keys[0] == node_id else None

    @property
    def pages(self) -> List[int]:
        return [p for n in self.nodes() for p in n.pages]

    def node_refs(self, node: _TrieNode) -> int:
        """Derived per-node refcount: live block-table mappings over the
        node's pages (each registered page carries exactly one pin, so
        anything beyond it is a table mapping)."""
        return sum(max(self._live(p) - 1, 0) for p in node.pages)

    # --- point lookups -------------------------------------------------- #
    def _locate(self, key: int) -> Tuple[_TrieNode, int]:
        node = self._index[key]
        return node, node.keys.index(key)

    def get(self, key: int, tokens: Optional[Sequence[int]] = None,
            now: float = 0.0) -> Optional[int]:
        node = self._index.get(key)
        if node is None:
            return None
        off = node.keys.index(key)
        if tokens is not None and tuple(tokens) != node.tokens[off]:
            return None                 # digest collision: NOT a match
        self.policy.record_hit(node.node_id, now)
        return node.pages[off]

    def entry(self, key: int) -> Tuple[int, Tuple[int, ...], int]:
        """(page, tokens, n_kvs) of a registered key."""
        node, off = self._locate(key)
        return node.pages[off], node.tokens[off], node.nkvs[off]

    # --- trie mutation -------------------------------------------------- #
    def _split(self, node: _TrieNode, keep: int, now: float) -> _TrieNode:
        """Split ``node`` after its first ``keep`` pages; the tail run
        becomes the single child of the (shrunk) front.  Returns the
        tail node.  Page-aligned by construction — runs only ever hold
        whole pages.  The tail's policy entry starts at ``now`` (splits
        happen on an active lookup/insert, so the path is warm)."""
        invariant(0 < keep < len(node.pages), (keep, len(node.pages)))
        tail = _TrieNode(node)
        tail.keys = node.keys[keep:]
        tail.pages = node.pages[keep:]
        tail.tokens = node.tokens[keep:]
        tail.nkvs = node.nkvs[keep:]
        del node.keys[keep:], node.pages[keep:]
        del node.tokens[keep:], node.nkvs[keep:]
        tail.children = node.children
        for child in tail.children.values():
            child.parent = tail
        node.children = {tail.node_id: tail}
        for k in tail.keys:
            self._index[k] = tail
        self.policy.record_resize(node.node_id, node.nkvs[-1])
        self.policy.record_insert(tail.node_id, tail.nkvs[-1], now)
        self.num_splits += 1
        return tail

    def _merge_single_child(self, parent: _TrieNode) -> None:
        """Path compression: absorb a lone child's run into ``parent``
        (triggered when an eviction unlinks a sibling).  The merged node
        keeps the parent's policy recency — the colder tail still evicts
        first, page by page, so the approximation never strands a hot
        front behind a cold merge partner."""
        if parent is self.root or len(parent.children) != 1:
            return
        (child,) = parent.children.values()
        self.policy.record_remove(child.node_id)
        parent.keys.extend(child.keys)
        parent.pages.extend(child.pages)
        parent.tokens.extend(child.tokens)
        parent.nkvs.extend(child.nkvs)
        parent.children = child.children
        for grand in parent.children.values():
            grand.parent = parent
        for k in child.keys:
            self._index[k] = parent
        self.policy.record_resize(parent.node_id, parent.nkvs[-1])
        self.num_merges += 1

    def insert(self, key: int, page: int, tokens: Sequence[int] = (),
               n_kvs: int = 0, now: float = 0.0,
               prev_key: Optional[int] = None) -> None:
        """Register one page under chain key ``key``, positioned right
        after ``prev_key`` in the trie (``None`` = first page of a
        prompt, i.e. a child of the root).  Extends the predecessor's
        run in place when it is a leaf tail, else starts a new child
        node (splitting the predecessor's node first when ``prev_key``
        sits mid-run)."""
        if key in self._index:
            # a silent re-register would leak the old page's +1 pin (and
            # under ``python -O`` a bare assert would not even fire)
            raise ValueError(
                f"prefix key {key} already registered "
                f"(page {self.entry(key)[0]})")
        if prev_key is None:
            parent = self.root
        else:
            if prev_key not in self._index:
                raise ValueError(f"prev_key {prev_key} is not registered")
            parent, off = self._locate(prev_key)
            if off != len(parent.keys) - 1:
                self._split(parent, off + 1, now)   # prev becomes the tail
        if parent is not self.root and not parent.children:
            # leaf tail: grow the run in place (per-grant incremental
            # registration lands here chunk after chunk)
            parent.keys.append(key)
            parent.pages.append(page)
            parent.tokens.append(tuple(tokens))
            parent.nkvs.append(int(n_kvs))
            self._index[key] = parent
            self.policy.record_resize(parent.node_id, int(n_kvs))
            self.policy.record_hit(parent.node_id, now)
        else:
            node = _TrieNode(parent)
            node.keys = [key]
            node.pages = [page]
            node.tokens = [tuple(tokens)]
            node.nkvs = [int(n_kvs)]
            parent.children[key] = node
            self._index[key] = node
            self.policy.record_insert(key, int(n_kvs), now)
        self._count += 1

    def lookup_run(self, keys: Sequence[int],
                   page_tokens: Optional[Sequence[Sequence[int]]] = None,
                   now: float = 0.0) -> List[int]:
        """Longest-prefix match: physical pages for the longest chain of
        ``keys`` resolvable from the root, O(L) with token re-
        verification at every node.  A key miss, or a token mismatch on
        a digest collision, ends the run (collision-is-a-miss).  A
        partial node match splits the node at the divergence point so
        the matched region is whole nodes — the hot front and the cold
        tail then age independently under the replacement policy."""
        pages: List[int] = []
        node = self.root
        i = 0
        while i < len(keys):
            child = node.children.get(keys[i])
            if child is None:
                break
            m = 0
            while m < len(child.pages) and i + m < len(keys):
                if child.keys[m] != keys[i + m]:
                    break
                if page_tokens is not None and \
                        tuple(page_tokens[i + m]) != child.tokens[m]:
                    break               # collision: verified away, a miss
                m += 1
            if m == 0:
                break
            full = m == len(child.pages)
            if not full:
                self._split(child, m, now)   # child keeps the matched front
            pages.extend(child.pages)
            self.policy.record_hit(child.node_id, now)
            i += m
            if not full:
                break                        # diverged inside the run
            node = child
        return pages

    def evict_tail(self, node: _TrieNode
                   ) -> Tuple[int, int, Tuple[int, ...], int]:
        """Pop the LAST page of a LEAF node (deepest first keeps device
        residency prefix-closed along every chain).  Returns ``(key,
        page, tokens, n_kvs)`` for the caller's demotion hook.  An
        emptied node is unlinked from its parent; a parent left with a
        single child merges back into one run."""
        invariant(not node.children,
                  "evict_tail on an interior node would strand children")
        invariant(node.pages, "evict_tail on an empty node")
        node_id = node.node_id
        key = node.keys.pop()
        page = node.pages.pop()
        tokens = node.tokens.pop()
        n_kvs = node.nkvs.pop()
        del self._index[key]
        self._count -= 1
        if node.pages:
            self.policy.record_resize(node_id, node.nkvs[-1])
        else:
            self.policy.record_remove(node_id)
            parent = node.parent
            del parent.children[node_id]
            node.parent = None
            self._merge_single_child(parent)
        return key, page, tokens, n_kvs

    def eviction_order(self, now: float = 0.0) -> List[int]:
        """Node ids, most-evictable first per the installed policy,
        LEAF-FIRST: interior nodes sort after every current leaf, so an
        eviction sweep never reaches a node that still has descendants
        until those descendants are gone."""
        def is_leaf(node_id: int) -> bool:
            n = self.node(node_id)
            return n is not None and not n.children
        return self.policy.eviction_order(now, leaf_of=is_leaf)

    # --- transactions ---------------------------------------------------- #
    def snapshot_state(self) -> Any:
        """Structural deep-copy (nodes, runs, counters) for step-txn
        rollback.  The policy is snapshotted separately by the txn
        (``txn.copy_state``); derived node refcounts need nothing."""
        flat: List[Tuple[int, List[int], List[int],
                         List[Tuple[int, ...]], List[int]]] = []

        def walk(n: _TrieNode, parent_idx: int) -> None:
            idx = len(flat)
            flat.append((parent_idx, list(n.keys), list(n.pages),
                         list(n.tokens), list(n.nkvs)))
            for child in n.children.values():
                walk(child, idx)

        walk(self.root, -1)
        return flat, self._count, self.num_splits, self.num_merges

    def restore_state(self, state: Any) -> None:
        flat, count, splits, merges = state
        nodes: List[_TrieNode] = []
        for parent_idx, keys, pages, tokens, nkvs in flat:
            parent = nodes[parent_idx] if parent_idx >= 0 else None
            n = _TrieNode(parent)
            n.keys, n.pages = list(keys), list(pages)
            n.tokens, n.nkvs = list(tokens), list(nkvs)
            if parent is not None:
                parent.children[n.node_id] = n
            nodes.append(n)
        self.root = nodes[0]
        self._index = {k: n for n in nodes for k in n.keys}
        self._count = count
        self.num_splits, self.num_merges = splits, merges

    # --- invariants ------------------------------------------------------ #
    def check_invariants(self) -> None:
        invariant(not self.root.keys and self.root.parent is None,
                  "root must own no pages")
        seen_pages: Set[int] = set()
        npages = 0
        node_ids: Set[int] = set()
        for n in self.nodes():
            invariant(n.keys, "non-root trie node with empty run")
            invariant(len(n.keys) == len(n.pages) == len(n.tokens)
                      == len(n.nkvs), "ragged node run")
            node_ids.add(n.node_id)
            npages += len(n.pages)
            for k in n.keys:
                invariant(self._index.get(k) is n,
                          f"index out of sync for key {k}")
            for p in n.pages:
                invariant(p not in seen_pages, f"page {p} in two nodes")
                seen_pages.add(p)
            for ck, child in n.children.items():
                invariant(child.parent is n and child.keys
                          and child.keys[0] == ck,
                          "child linkage broken")
        for ck, child in self.root.children.items():
            invariant(child.parent is self.root and child.keys
                      and child.keys[0] == ck, "root child linkage broken")
        invariant(npages == self._count == len(self._index),
                  (npages, self._count, len(self._index)))
        invariant(node_ids == set(self.policy._seq),
                  "policy metadata out of sync with trie nodes")

    # legacy name: the digest chain is shared with schedulers/benchmarks
    chain_keys = staticmethod(chain_keys)


# The chained-hash ``PrefixCache`` grew into the radix trie; the old
# name stays importable for callers that only need ``chain_keys`` or
# the point API (``get``/``insert``/``entry``).
PrefixCache = RadixPrefixRegistry


class PagedAllocator:
    def __init__(self, num_pages: int, page_size: int, *,
                 policy: Optional[ReplacementPolicy] = None,
                 on_evict: Optional[
                     Callable[[int, int, Tuple[int, ...], int], None]]
                 = None):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError(f"num_pages={num_pages}, page_size={page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._tables: Dict[int, BlockTable] = {}
        self._refs: Dict[int, int] = {}     # page -> refcount (tables + pin)
        self._pinned: Set[int] = set()      # pages pinned by the registry
        self.prefix_cache = RadixPrefixRegistry(
            policy, live=lambda page: self._refs.get(page, 0))
        # demotion hook: called as (key, page, page tokens, chain depth)
        # BEFORE an evicted page returns to the free list, while its
        # pool contents are still intact — drivers snapshot it to the
        # host tier here
        self.on_evict = on_evict
        # virtual-time clock the replacement policy scores against;
        # drivers (engine / simulator shadow) keep it current
        self.now = 0.0
        # bumped on every block-table mutation — lets the engine cache
        # its device-side block-table upload across decode steps and
        # invalidate it without tracking call sites by hand
        self.version = 0
        # rids whose PAGE LIST changed since the last consume_dirty():
        # the delta companion to ``version`` — a version bump tells the
        # engine its device tables are stale, the dirty set tells it
        # WHICH host rows to rewrite before the one refresh upload
        self.dirty: Set[int] = set()
        # fault-injection hook: called as fault_hook(need) before pages
        # are taken — a seeded FaultPlan raises a transient FaultError
        # here to model device allocation failures (serving.faults)
        self.fault_hook: Optional[Callable[[int], None]] = None
        self.stats: Dict[str, int] = {
            SK.PREFIX_HITS: 0, SK.PREFIX_SHARED_TOKENS: 0,
            SK.COW_COPIES: 0, SK.RECLAIMED: 0, SK.RECLAIM_SKIPPED: 0}

    # ------------------------------------------------------------------ #
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        """Physical pages holding live data (tables and/or registry)."""
        return self.num_pages - len(self._free)

    @property
    def table_pages(self) -> int:
        """Pages referenced by at least one block table (excludes pages
        alive only as registry-cached prefixes)."""
        return len({p for t in self._tables.values() for p in t.pages})

    def tokens_capacity(self) -> int:
        return self.num_pages * self.page_size

    def free_tokens(self) -> int:
        return self.free_pages * self.page_size

    def table(self, rid: int) -> BlockTable:
        return self._tables[rid]

    def has(self, rid: int) -> bool:
        return rid in self._tables

    def consume_dirty(self) -> Set[int]:
        """Return-and-clear the rids whose page lists changed since the
        last call — the engine rewrites exactly those host block-table
        rows before its one refresh upload (a freed rid may appear; the
        caller skips rids with no slot)."""
        dirty, self.dirty = self.dirty, set()
        return dirty

    def pages_needed(self, rid: int, new_tokens: int) -> int:
        if new_tokens <= 0:
            return 0
        cur = self._tables.get(rid)
        have = len(cur.pages) * self.page_size - cur.num_tokens if cur else 0
        need_tokens = max(0, new_tokens - have)
        return (need_tokens + self.page_size - 1) // self.page_size

    # --- refcount plumbing --------------------------------------------- #
    def _decref(self, page: int) -> None:
        self._refs[page] -= 1
        invariant(self._refs[page] >= 0, page)
        if self._refs[page] == 0:
            del self._refs[page]
            self._free.append(page)

    def _take(self, need: int) -> List[int]:
        """Pop ``need`` free pages, reclaiming trie nodes in the
        replacement policy's eviction order when the free list runs
        short — cached prefixes never block a request the scheduler
        admitted.

        The sweep is LEAF-FIRST (``RadixPrefixRegistry.eviction_order``)
        and evicts each node's pages TAIL-FIRST, so an interior node is
        never dismantled while descendants still chain through it and
        device residency stays prefix-closed.  A node whose tail page a
        live block table still maps is SKIPPED where it stands — the pin
        drop would free nothing — and counted in
        ``stats["reclaim_skipped"]``.  The outer loop re-walks the order
        while it makes progress: evicting a whole leaf exposes its
        parent as the next candidate.  Each genuinely evicted page is
        offered to ``on_evict`` (host demotion) before it returns to the
        free list, and only those count as ``reclaimed``."""
        if self.fault_hook is not None and need > 0:
            self.fault_hook(need)
        reg = self.prefix_cache
        if len(self._free) < need and len(reg):
            progress = True
            while len(self._free) < need and progress:
                progress = False
                for node_id in reg.eviction_order(self.now):
                    if len(self._free) >= need:
                        break
                    node = reg.node(node_id)
                    if node is None or node.children:
                        continue       # merged away mid-sweep / interior
                    blocked = False
                    while node.pages and len(self._free) < need:
                        page = node.pages[-1]
                        if self._refs[page] > 1:  # pin + live table map(s)
                            blocked = True
                            break
                        key, page, tokens, n_kvs = reg.evict_tail(node)
                        self._pinned.discard(page)
                        if self.on_evict is not None:
                            self.on_evict(key, page, tokens, n_kvs)
                        self._decref(page)        # pin was the only ref
                        self.stats[SK.RECLAIMED] += 1
                        progress = True
                    if blocked:
                        self.stats[SK.RECLAIM_SKIPPED] += 1
        if need > len(self._free):
            raise OutOfPagesError(
                f"need {need} pages, {len(self._free)} free "
                f"({len(self.prefix_cache)} cached prefix pages left, "
                f"none evictable)")
        granted = [self._free.pop() for _ in range(need)]
        for p in granted:
            invariant(p not in self._refs, p)
            self._refs[p] = 1
        return granted

    # ------------------------------------------------------------------ #
    def allocate(self, rid: int, new_tokens: int) -> List[int]:
        """Extend rid's table by new_tokens; returns newly granted pages.
        A zero-token grant is a NO-OP (no phantom empty table)."""
        if new_tokens <= 0:
            return []
        need = self.pages_needed(rid, new_tokens)
        if need:
            # version tracks the PAGE LISTS only: an in-page append
            # (decode filling its current page) must not invalidate the
            # engine's cached device block tables
            self.version += 1
            self.dirty.add(rid)
        granted = self._take(need)
        tbl = self._tables.setdefault(rid, BlockTable())
        tbl.pages.extend(granted)
        tbl.num_tokens += new_tokens
        return granted

    def share(self, rid: int, pages: Sequence[int], num_tokens: int) -> None:
        """Map existing (registry-held) pages as the PREFIX of rid's
        table — shared-prefix reuse.  Only full pages are shareable and
        the table must be empty (prefix attach happens at first claim)."""
        invariant(rid not in self._tables, rid)
        invariant(num_tokens == len(pages) * self.page_size,
                  (num_tokens, len(pages), self.page_size))
        for p in pages:
            invariant(self._refs.get(p, 0) > 0, f"page {p} is not live")
            self._refs[p] += 1
        self.version += 1
        self.dirty.add(rid)
        self._tables[rid] = BlockTable(list(pages), num_tokens)
        self.stats[SK.PREFIX_HITS] += 1
        self.stats[SK.PREFIX_SHARED_TOKENS] += num_tokens

    def extend_shared(self, rid: int, page: int, num_tokens: int) -> None:
        """Append ONE live (registry-held) page to the tail of rid's
        table — the host-promotion path of a prefix attach extends the
        run page by page.  The table must be whole full pages so far."""
        tbl = self._tables[rid]
        invariant(num_tokens == self.page_size, num_tokens)
        invariant(tbl.num_tokens == len(tbl.pages) * self.page_size,
                  (rid, tbl.num_tokens, len(tbl.pages)))
        invariant(self._refs.get(page, 0) > 0, f"page {page} is not live")
        self._refs[page] += 1
        self.version += 1
        self.dirty.add(rid)
        tbl.pages.append(page)
        tbl.num_tokens += num_tokens
        self.stats[SK.PREFIX_SHARED_TOKENS] += num_tokens

    def ensure_private(self, rid: int,
                       page_index: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write guard: before WRITING into table page
        ``page_index``, remap it to a fresh private page if it is shared
        (refcount > 1) or registry-pinned.  Returns ``(old, new)`` when a
        copy is needed (the caller must copy pool contents old -> new),
        else None."""
        tbl = self._tables[rid]
        page = tbl.pages[page_index]
        if self._refs[page] == 1 and page not in self._pinned:
            return None
        self.version += 1
        self.dirty.add(rid)
        new = self._take(1)[0]
        tbl.pages[page_index] = new
        self._decref(page)
        self.stats[SK.COW_COPIES] += 1
        return page, new

    def free(self, rid: int) -> int:
        """Release all pages of rid (preemption/completion). Returns count.
        Registry-pinned pages stay alive as cached prefixes."""
        tbl = self._tables.pop(rid, None)
        if tbl is None:
            return 0
        self.version += 1
        self.dirty.add(rid)
        for p in reversed(tbl.pages):
            self._decref(p)
        return len(tbl.pages)

    def free_tail(self, rid: int, npages: int) -> int:
        """Release only the LAST ``npages`` pages of rid's table
        (page-level partial preemption).  Returns the tokens removed;
        the kept pages are full, so the new boundary is page-aligned."""
        tbl = self._tables[rid]
        invariant(0 < npages <= len(tbl.pages),
                  (rid, npages, len(tbl.pages)))
        self.version += 1
        self.dirty.add(rid)
        removed = tbl.pages[-npages:]
        del tbl.pages[-npages:]
        kept_cap = len(tbl.pages) * self.page_size
        tokens_removed = tbl.num_tokens - min(tbl.num_tokens, kept_cap)
        tbl.num_tokens = min(tbl.num_tokens, kept_cap)
        for p in reversed(removed):
            self._decref(p)
        if not tbl.pages:
            del self._tables[rid]
        return tokens_removed

    # --- radix-trie prefix registry ------------------------------------ #
    def lookup_prefix(self, keys: Sequence[int],
                      page_tokens: Optional[Sequence[Sequence[int]]] = None
                      ) -> List[int]:
        """Physical pages for the LONGEST matching prefix of ``keys``
        (trie walk from the root; a key miss — or a token-verification
        failure on a digest collision — ends the run).  ``page_tokens[i]``
        are the token ids of page ``i``, compared against each node's
        stored tokens when given."""
        return self.prefix_cache.lookup_run(keys, page_tokens,
                                            now=self.now)

    def register_prefix(self, rid: int, keys: Sequence[int],
                        page_tokens: Sequence[Sequence[int]] = ()
                        ) -> int:
        """Publish rid's first ``len(keys)`` table pages into the trie
        under their chained content keys (pin +1 each), storing each
        page's token ids for collision verification and its chain depth
        ``n_kvs`` for the break-even policy.  Keys already registered —
        including rid's own attached shared prefix — are skipped and
        anchor the chain, so successive per-grant calls EXTEND the same
        node run chunk after chunk.  Returns the number of newly
        registered pages."""
        tbl = self._tables[rid]
        n = min(len(keys), len(tbl.pages))
        registered = 0
        prev: Optional[int] = None
        for i in range(n):
            key, page = keys[i], tbl.pages[i]
            if key in self.prefix_cache:
                prev = key
                continue
            if page in self._pinned:
                # the page is registered under a DIFFERENT key: the
                # chain position of everything deeper is unknowable
                break
            toks = page_tokens[i] if i < len(page_tokens) else ()
            self.prefix_cache.insert(key, page, toks,
                                     n_kvs=(i + 1) * self.page_size,
                                     now=self.now, prev_key=prev)
            self._pinned.add(page)
            self._refs[page] += 1
            registered += 1
            prev = key
        return registered

    def promote_prefix(self, key: int, tokens: Sequence[int],
                       n_kvs: int, prev_key: Optional[int] = None) -> int:
        """Re-admit a host-demoted prefix page: take one page (this may
        itself reclaim/demote colder nodes) and insert it into the trie
        right after ``prev_key`` — its chain predecessor, which the
        attach loop guarantees is resident and table-mapped, so the
        take's own reclaim can never evict the run being rebuilt.  The
        caller writes the host snapshot into the returned page and
        charges the swap-in."""
        page = self._take(1)[0]
        # _take set refs[page] = 1 — here that single ref IS the pin
        self.prefix_cache.insert(key, page, tokens, n_kvs=n_kvs,
                                 now=self.now, prev_key=prev_key)
        self._pinned.add(page)
        return page

    # ------------------------------------------------------------------ #
    def check_invariants(self) -> None:
        held = sorted(self._refs)
        all_pages = held + self._free
        invariant(len(all_pages) == self.num_pages, "page leak")
        invariant(len(set(all_pages)) == self.num_pages,
                  "double allocation")
        # refcount == table memberships + registry pin, everywhere
        counts: Dict[int, int] = {}
        for rid, t in self._tables.items():
            invariant(t.pages, f"rid {rid}: empty block table")
            cap = len(t.pages) * self.page_size
            invariant(0 < t.num_tokens <= cap, (rid, t.num_tokens, cap))
            for p in t.pages:
                counts[p] = counts.get(p, 0) + 1
        for p in self._pinned:
            counts[p] = counts.get(p, 0) + 1
        invariant(counts == self._refs, (counts, self._refs))
        invariant(self._pinned == set(self.prefix_cache.pages),
                  (self._pinned, self.prefix_cache.pages))
        self.prefix_cache.check_invariants()


# --------------------------------------------------------------------- #
# two-tier prefix attach (device trie, then host demotion tier)
# --------------------------------------------------------------------- #


def attach_prefix_run(alloc: PagedAllocator, rid: int,
                      keys: Sequence[int],
                      page_tokens: Sequence[Sequence[int]],
                      host_tier: Any = None,
                      restore: Optional[Callable[[int, Any], None]] = None,
                      verify: Optional[Callable[[Any], bool]] = None,
                      exact: bool = False) -> Tuple[int, int]:
    """Map the longest matching run of cached prefix pages starting at
    page 0 into rid's (empty) block table: first a DEVICE trie walk
    (``lookup_prefix`` — partial hits included), then — when
    ``host_tier`` is given — a page-by-page extension against
    host-demoted ``PrefixPageEntry`` snapshots, which are PROMOTED back:
    one fresh page taken (possibly demoting colder nodes), re-inserted
    into the trie after its chain predecessor, and filled via
    ``restore(page, entry.kv)``.  Device pages are table-mapped (and so
    refcount-protected) before any promotion runs, and each promoted
    page is mapped before the next key is resolved — a promotion's own
    reclaim can never evict pages of the run being built.  The two
    phases are equivalent to a per-key interleave because eviction is
    tail-first along every chain: device residency is prefix-closed, so
    no deeper key can be device-resident once one key has missed.

    ``verify(entry)`` — when given — gates every host promotion: a
    False verdict (CRC mismatch, injected promote fault) DROPS the
    demoted entry and ends the run there, so a rotten host snapshot
    degrades to a trie miss (recompute) instead of restoring wrong KV.
    The engine passes ``swap_store.verify_entry`` composed with its
    fault plan; the simulator mirrors the same plan draws.

    ``exact=True`` is the pre-trie ablation mode
    (``prefix_lookup="exact"``): the attach is all-or-nothing — unless
    EVERY queried key resolves on the device, nothing attaches and no
    host promotion is attempted.  Benchmarks use it to isolate what
    partial-prefix matching buys.

    Returns ``(attached_tokens, promoted_tokens)``; the caller charges
    ``swap_time(promoted_tokens)`` — the Fig. 8 host-link price of the
    promotions.  Shared by the serving engine (real pool copies) and the
    simulator's virtual-time shadow (``restore=None``).
    """
    pg = alloc.page_size
    pages = alloc.lookup_prefix(keys, page_tokens)
    if exact and len(pages) < len(keys):
        return 0, 0
    attached = promoted = 0
    for page in pages:
        if attached == 0:
            alloc.share(rid, [page], pg)  # repro: allow-unpriced-mutation(sharing maps an existing device page - no bytes move; attached tokens are returned for the caller's prefix_stats)
        else:
            alloc.extend_shared(rid, page, pg)  # repro: allow-unpriced-mutation(same zero-copy mapping as the share above)
        attached += pg
    i = len(pages)
    while host_tier is not None and not exact and i < len(keys):
        key, toks = keys[i], page_tokens[i]
        if key in alloc.prefix_cache:
            # the trie walk stopped BEFORE this key, so a registered
            # entry here holds DIFFERENT tokens (a digest collision) —
            # promoting the host copy would try to re-insert the key; a
            # collision must degrade to a miss, never an error (and
            # never another prompt's KV)
            break
        entry = host_tier.peek_prefix(key, toks)
        if entry is None:
            break
        if verify is not None and not verify(entry):
            # integrity failure: drop the rotten snapshot and stop the
            # run — the pages it would have covered recompute
            host_tier.discard_prefix(key)  # repro: allow-unpriced-mutation(dropping a corrupt entry moves no bytes; the caller counts it in its integrity stats)
            break
        try:
            # repro: allow-unpriced-mutation(priced by the caller - promoted tokens are returned and charged swap_time into the batch, parity-tested engine vs simulator)
            page = alloc.promote_prefix(key, entry.tokens, entry.n_kvs,
                                        prev_key=keys[i - 1] if i else None)
        except OutOfPagesError:
            break                   # nothing evictable: stop the run
        host_tier.pop_prefix(key)  # repro: allow-unpriced-mutation(the promotion above carries the charge; the pop only hands the entry over)
        if restore is not None:
            restore(page, entry.kv)
        if attached == 0:
            alloc.share(rid, [page], pg)  # repro: allow-unpriced-mutation(sharing maps an existing device page - no bytes move; attached tokens are returned for the caller's prefix_stats)
        else:
            alloc.extend_shared(rid, page, pg)  # repro: allow-unpriced-mutation(same zero-copy mapping as the share above)
        attached += pg
        promoted += pg
        i += 1
    return attached, promoted
