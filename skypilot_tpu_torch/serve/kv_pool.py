"""The port's copy of the JAX package's ``serve/kv_pool.py`` (it imports
nothing of that package); names and behaviour are as there.

Paged KV-cache block pool: host-side bookkeeping for the ONE
device-resident pool of KV blocks the paged decode engine allocates
slots and the shared-prefix cache out of.

The dense engine gives every slot a full ``(layers, max_seq, ...)``
cache row, so concurrency is sized for the worst-case sequence (and it
has no prefix cache — the old host-side splice pool was retired when
the paged trie subsumed it). Paging collapses slot growth and prefix
sharing into one device buffer of ``num_blocks`` fixed-size blocks
(block = the engine's prefill chunk):

  * slots acquire blocks lazily as they prefill/decode (a per-slot
    block TABLE maps logical chunk index -> physical block id);
  * shared prefixes are ALIASED: the trie (:class:`PagedPrefixCache`)
    maps chunk token-tuples to refcounted pool blocks, so a hit is a
    block-table entry write — zero-copy, no splice, no host round-trip
    — and publish-on-free is a refcount transfer, not a D2H gather;
  * eviction is block-LRU over unpinned trie leaves; blocks referenced
    by a live slot are never evicted;
  * admission is free-block based with a worst-case RESERVATION
    (ceil((prompt + max_tokens) / block) minus aliased blocks), so an
    admitted request can never stall mid-stream for a block —
    backpressure is deterministic and preemption-free (FIFO head
    waits; nothing already decoding is ever evicted or rolled back).

Physical block ids are content-transparent: attention gathers K/V
through the table, so two hosts of a gang replica may lay the same
requests out on different physical blocks (admission timing skew) and
still produce bit-identical tokens — the lockstep contract depends on
request order and seeds, never on placement.

Block 0 is a reserved SCRATCH block, never allocated: free slots ride
along in the batched decode step with ``pos 0`` and their (ignored)
K/V writes land there instead of clobbering a live slot's block.

Below the device pool sits an optional second tier
(:class:`HostBlockPool`): on LRU eviction a leaf's block is SPILLED
D2H into a bounded host-RAM pool instead of destroyed — the trie node
stays, flipping to HOST residency (``block == -1``) — and a later
match that reaches the node re-admits it H2D into a freshly reserved
block during the prefill phase. Residency along any root→leaf path is
always a device-resident prefix followed by a host-resident suffix
(spill picks deepest-device victims; re-admission and publish promote
parent-first), which is what keeps match/eviction bookkeeping local.
Tiering is INCLUSIVE: re-admission leaves the host copy in place, so
re-evicting a promoted block is a free demotion.

All mutation happens on the engine's compute thread; the trie lock
only makes the read-only ``stats()``/``nodes()`` safe from tests and
handlers (and the spill callback, which the engine wires in, safe to
hand blocks to). The host pool has its own lock: the engine's D2H
drain thread ``put``s while the compute thread matches and ``get``s.
Stdlib + the in-process metrics registry, nothing else — no jax in
here (the device arrays live in the engine; this module owns the
arithmetic of who holds which block).
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from skypilot_tpu_torch.observability import metrics

_EVICTIONS = metrics.counter(
    "stpu_engine_kv_pool_evictions_total",
    "Prefix-trie LRU evictions by outcome: spilled = block demoted "
    "D2H into the host tier (the trie node survives, HOST-resident); "
    "dropped = leaf destroyed outright (tier off, injected fault, or "
    "drain backpressure).", ("outcome",))


def block_bytes(block_tokens: int, n_layers: int, n_kv_heads: int,
                head_dim: int, *, quantized: bool = False,
                kv_dtype_bytes: int = 2) -> int:
    """Device bytes ONE pool block costs across all layers: K and V
    codes for ``block_tokens`` rows, plus (quantized) one f32 scale
    per (layer, kv_head) for each of K and V. The int8 layout is
    1 byte/element + the scale tax, so at the usual geometries a
    quantized block is just over half a bf16 block — which is why the
    same HBM budget fits ~2x the blocks (the >= 1.8x capacity gate in
    the q8 bench leg)."""
    per_elem = 1 if quantized else int(kv_dtype_bytes)
    rows = 2 * n_layers * block_tokens * n_kv_heads * head_dim
    scales = 2 * n_layers * n_kv_heads * 4 if quantized else 0
    return rows * per_elem + scales


def blocks_for_budget(budget_bytes: int, block_tokens: int,
                      n_layers: int, n_kv_heads: int, head_dim: int, *,
                      quantized: bool = False,
                      kv_dtype_bytes: int = 2) -> int:
    """How many pool blocks (scratch included) fit in ``budget_bytes``
    of HBM — the capacity half of the quantization bench: the q8 leg
    sizes a bf16 pool and a quantized pool off the SAME byte budget
    and asserts the quantized one holds >= 1.8x the blocks."""
    bb = block_bytes(block_tokens, n_layers, n_kv_heads, head_dim,
                     quantized=quantized, kv_dtype_bytes=kv_dtype_bytes)
    return int(budget_bytes) // bb


class BlockPool:
    """Free-list + refcount accounting for ``num_blocks`` KV blocks of
    ``block_tokens`` tokens each (block 0 reserved as scratch).

    A block's refcount counts its OWNERS: +1 per live slot whose table
    maps to it, +1 while the prefix trie holds it. It returns to the
    free list when the count hits zero. Allocation order is FIFO over
    a deque — deterministic, so seeded runs replay exactly.
    """

    def __init__(self, num_blocks: int, block_tokens: int):
        if num_blocks < 2:
            raise ValueError(
                f"kv pool needs >= 2 blocks (1 scratch + 1 usable); "
                f"got {num_blocks}")
        if block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, got "
                             f"{block_tokens}")
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(block_tokens)
        self._free: "collections.deque[int]" = collections.deque(
            range(1, self.num_blocks))
        self._refs: Dict[int, int] = {}
        self._reserved = 0
        self.peak_in_use = 0          # high-water mark (bench leg)

    # ------------------------------------------------------------ sizing
    @property
    def usable_blocks(self) -> int:
        """Blocks a request can actually occupy (scratch excluded)."""
        return self.num_blocks - 1

    def blocks_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.block_tokens)

    # -------------------------------------------------------- accounting
    def free_blocks(self) -> int:
        return len(self._free)

    def in_use(self) -> int:
        return self.usable_blocks - len(self._free)

    def available(self) -> int:
        """Free blocks not yet promised to an admitted slot — what a
        NEW admission may reserve."""
        return len(self._free) - self._reserved

    def reserve(self, n: int) -> None:
        """Promise ``n`` free blocks to an admitted slot (the
        preemption-free admission contract: once admitted, every block
        the request can ever need is already set aside)."""
        if n > self.available():
            raise RuntimeError(
                f"reserve({n}) with only {self.available()} available "
                "— admission must check available() first")
        self._reserved += int(n)

    def unreserve(self, n: int) -> None:
        """Return unused reservation (slot finished under worst case)."""
        self._reserved -= int(n)
        if self._reserved < 0:
            raise RuntimeError("kv pool reservation underflow")

    def alloc(self, *, reserved: bool = True) -> int:
        """Take a free block (refcount 1). ``reserved`` draws the block
        against an admission reservation (the normal slot path)."""
        if not self._free:
            raise RuntimeError("kv pool exhausted — a reservation was "
                               "bypassed or leaked")
        block = self._free.popleft()
        if reserved:
            self.unreserve(1)
        self._refs[block] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use())
        return block

    def retain(self, block: int) -> None:
        self._refs[block] += 1

    def release(self, block: int) -> None:
        refs = self._refs.get(int(block))
        if refs is None:
            raise RuntimeError(f"release of free block {block} — "
                               "double-release (refcount leak inverse)")
        if refs == 1:
            del self._refs[int(block)]
            self._free.append(int(block))
        else:
            self._refs[int(block)] = refs - 1

    def refcount(self, block: int) -> int:
        return self._refs.get(int(block), 0)


class HostBlockPool:
    """Bounded host-RAM spill tier under the paged trie.

    Entries are spilled KV blocks keyed by the victim node's trie PATH
    (the tuple of chunk token-tuples from the root — a block's contents
    depend on the entire prefix through causal attention, so nothing
    shorter can key them) and valued by a dict of per-leaf host arrays
    (the drained D2H copies); sizing is by their ``nbytes``. LRU over
    an OrderedDict against a byte budget: storing past the budget drops
    the oldest entries first, and an entry larger than the whole budget
    is refused outright.

    ``mark_inflight`` lets the engine register a spill whose D2H drain
    has not landed yet: ``has`` counts it (so the trie keeps the node
    instead of pruning a prefix whose bytes are seconds away) but
    ``get`` does not (admission can't restore bytes it can't read —
    that request simply prefills the tail fresh).

    Thread-safe under its own lock: the engine's background drain
    thread ``put``s while the compute thread matches and ``get``s.
    """

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[Tuple, Dict[str, Any]]"\
            = collections.OrderedDict()
        self._sizes: Dict[Tuple, int] = {}
        self._inflight: set = set()
        self.bytes_used = 0
        self.stored = 0        # completed spills (successful put)
        self.lru_dropped = 0   # entries dropped to fit the budget
        self.rehits = 0        # get() hits -> re-admissions

    def has(self, path: Tuple) -> bool:
        """Stored OR in flight — the trie's keep-the-node predicate."""
        with self._lock:
            return path in self._entries or path in self._inflight

    __contains__ = has

    def mark_inflight(self, path: Tuple) -> None:
        with self._lock:
            self._inflight.add(path)

    def clear_inflight(self, path: Tuple) -> None:
        with self._lock:
            self._inflight.discard(path)

    def put(self, path: Tuple, arrays: Dict[str, Any]) -> bool:
        """Store a drained block; False when it cannot fit (dropped)."""
        nbytes = sum(int(getattr(v, "nbytes", 0))
                     for v in arrays.values())
        with self._lock:
            self._inflight.discard(path)
            if nbytes > self.budget_bytes:
                return False
            old = self._sizes.pop(path, 0)
            if old:
                del self._entries[path]
                self.bytes_used -= old
            while self._entries and \
                    self.bytes_used + nbytes > self.budget_bytes:
                dead, _ = self._entries.popitem(last=False)
                self.bytes_used -= self._sizes.pop(dead)
                self.lru_dropped += 1
            self._entries[path] = arrays
            self._sizes[path] = nbytes
            self.bytes_used += nbytes
            self.stored += 1
            return True

    def get(self, path: Tuple) -> Optional[Dict[str, Any]]:
        """Fetch for re-admission (LRU-touches; the entry STAYS — the
        tier is inclusive, so churn after the first spill is free)."""
        with self._lock:
            arrays = self._entries.get(path)
            if arrays is not None:
                self._entries.move_to_end(path)
                self.rehits += 1
            return arrays

    def discard(self, path: Tuple) -> None:
        """Drop an entry (trie pruned the node: the bytes are
        unreachable through any future match)."""
        with self._lock:
            self._inflight.discard(path)
            size = self._sizes.pop(path, None)
            if size is not None:
                del self._entries[path]
                self.bytes_used -= size

    def blocks(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"bytes": self.bytes_used,
                    "blocks": len(self._entries),
                    "budget_bytes": self.budget_bytes,
                    "spilled": self.stored,
                    "lru_dropped": self.lru_dropped,
                    "rehits": self.rehits,
                    "inflight": len(self._inflight)}


class _BlockNode:
    """One prompt chunk in the paged trie: a token-tuple key mapping to
    one pool block. ``refs`` counts live slots whose admission aliased
    this node (pins — never evicted while > 0). ``block == -1`` is the
    HOST residency state: the device block was spilled to the host
    tier, keyed by ``path`` (the full chunk-key chain from the root)."""

    __slots__ = ("key", "parent", "children", "block", "refs", "tick",
                 "path")

    def __init__(self, key, parent: Optional["_BlockNode"], block: int):
        self.key = key
        self.parent = parent
        self.children: Dict[tuple, "_BlockNode"] = {}
        self.block = int(block)
        self.refs = 0
        self.tick = 0
        self.path: Tuple = (() if parent is None
                            else parent.path + (key,))


class PagedPrefixCache:
    """Chunk-granular trie over POOL BLOCKS — the only prefix-cache
    representation (the dense host-pool splice cache is retired):
    a cached chunk IS a device block, a hit IS a table write.

    Eviction is LRU over unpinned leaves (an interior node's block is a
    dependency of every deeper cached prefix) and runs on demand from
    admission: when a new request's reservation does not fit, leaves
    are evicted until it does or nothing unpinned remains (then the
    request waits — deterministic FIFO backpressure).

    With a ``host_pool`` + ``spill`` callback wired in (the tiered
    engine), eviction first offers the victim to the spill path: on
    success the device block is released but the NODE stays, flipping
    to HOST residency (``block == -1``); a later match re-admits it.
    ``spill(node)`` must be non-blocking — it snapshots the block D2H
    asynchronously (the engine's drain thread lands the bytes) and
    returns False to decline (fault, backpressure, tier off), which
    degrades that eviction to today's drop.
    """

    def __init__(self, pool: BlockPool, chunk: int, *,
                 host_pool: Optional[HostBlockPool] = None,
                 spill: Optional[Callable[["_BlockNode"], bool]] = None):
        self.pool = pool
        self.chunk = int(chunk)
        self.host_pool = host_pool
        self._spill = spill if host_pool is not None else None
        self._root = _BlockNode(None, None, -1)
        self._lock = threading.Lock()
        self._tick = 0
        self._chunks = 0
        self._host_chunks = 0
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0
        self.zero_copy_hits = 0
        self.spills = 0        # evictions demoted to the host tier
        self.drops = 0         # evictions that destroyed the leaf
        self.promotions = 0    # host nodes re-admitted / re-published

    # ------------------------------------------------------------ match
    def match(self, prompt: List[int]) -> List[_BlockNode]:
        """Longest cached prefix of ``prompt`` in full chunks, capped so
        at least one prompt token is left to prefill (the first output
        token must be sampled from real logits). Pure lookup — no pins,
        no counters (admission may still fail on reservation)."""
        max_chunks = (len(prompt) - 1) // self.chunk
        with self._lock:
            node, matched = self._root, []
            for j in range(max_chunks):
                key = tuple(prompt[j * self.chunk:(j + 1) * self.chunk])
                child = node.children.get(key)
                if child is None:
                    break
                if child.block < 0:
                    # HOST residency: matchable only while the spilled
                    # bytes still exist (stored or D2H in flight). A
                    # node whose payload was LRU-dropped from the host
                    # tier is dead weight — prune it lazily here.
                    if self.host_pool is None or \
                            not self.host_pool.has(child.path):
                        self._prune_dead_locked(child)
                        break
                matched.append(child)
                node = child
            return matched

    def _prune_dead_locked(self, node: _BlockNode) -> None:
        """Delete a host-resident node whose payload is gone, plus its
        (necessarily host-resident) subtree — unless anything in it is
        still pinned by a pending re-admission. Caller holds the lock."""
        stack, doomed = [node], []
        while stack:
            n = stack.pop()
            if n.refs > 0 or n.block >= 0:
                return
            doomed.append(n)
            stack.extend(n.children.values())
        del node.parent.children[node.key]
        for n in doomed:
            self._chunks -= 1
            self._host_chunks -= 1
            if self.host_pool is not None:
                self.host_pool.discard(n.path)

    def pin(self, nodes: List[_BlockNode]) -> None:
        """Pin matched nodes for a slot: bumps each node's pin count
        AND the block's pool refcount (the slot's table now owns a
        reference — the zero-copy alias)."""
        with self._lock:
            self._tick += 1
            for node in nodes:
                node.refs += 1
                node.tick = self._tick
                self.pool.retain(node.block)

    def unpin(self, nodes: List[_BlockNode]) -> None:
        """Exact inverse of :meth:`pin` — admission rollback AND the
        slot-free release path (callers clear their held list after,
        which is what makes release idempotent at the slot level)."""
        with self._lock:
            for node in nodes:
                node.refs -= 1
                if node.refs < 0:
                    raise RuntimeError(
                        f"trie pin underflow on chunk {node.key!r} — "
                        "double release")
                self.pool.release(node.block)

    def pin_pending(self, nodes: List[_BlockNode]) -> None:
        """Pin HOST-resident nodes a slot is about to re-admit: bumps
        the node pin count only — there is no device block to retain
        yet (the restore path allocates one and :meth:`promote`\\ s).
        The pin keeps eviction's drop path and match's lazy prune off
        a node whose payload an admitted slot already fetched."""
        with self._lock:
            self._tick += 1
            for node in nodes:
                node.refs += 1
                node.tick = self._tick

    def unpin_pending(self, nodes: List[_BlockNode]) -> None:
        """Inverse of :meth:`pin_pending` for nodes whose restore never
        ran (cancel / error before the re-admit reached them)."""
        with self._lock:
            for node in nodes:
                node.refs -= 1
                if node.refs < 0:
                    raise RuntimeError(
                        f"trie pending-pin underflow on chunk "
                        f"{node.key!r} — double release")

    def promote(self, node: _BlockNode, block: int) -> None:
        """Flip a HOST-resident node back to device residency after its
        bytes were restored into ``block``: the trie takes ownership
        (retain), mirroring adoption at publish. The host copy stays —
        the tier is inclusive, so re-evicting this block later is a
        free demotion (no second D2H)."""
        with self._lock:
            if node.block >= 0:
                raise RuntimeError(
                    f"promote of device-resident chunk {node.key!r}")
            node.block = int(block)
            self.pool.retain(node.block)
            self._tick += 1
            node.tick = self._tick
            self._host_chunks -= 1
            self.promotions += 1

    def note_result(self, matched_chunks: int) -> None:
        """Count a successful admission's hit/miss + tokens saved."""
        with self._lock:
            if matched_chunks:
                self.hits += 1
                self.zero_copy_hits += 1
                self.tokens_saved += matched_chunks * self.chunk
            else:
                self.misses += 1

    # ---------------------------------------------------------- publish
    def publish(self, prompt: List[int], valid_tokens: int,
                block_of) -> int:
        """Adopt ``prompt``'s leading full chunks (up to
        ``valid_tokens``, the prefilled frontier) into the trie.
        ``block_of(j)`` returns the slot's physical block for chunk
        ``j``; adoption is a refcount TRANSFER (pool.retain — the trie
        becomes an owner; the freeing slot drops its own reference
        right after), never a copy. Chunks already cached keep their
        existing block; the slot's duplicate simply frees. Returns the
        number of chunks adopted."""
        n_chunks = min(valid_tokens, len(prompt)) // self.chunk
        adopted = 0
        with self._lock:
            self._tick += 1
            node = self._root
            for j in range(n_chunks):
                key = tuple(prompt[j * self.chunk:(j + 1) * self.chunk])
                child = node.children.get(key)
                if child is None:
                    child = _BlockNode(key, node, block_of(j))
                    node.children[key] = child
                    self.pool.retain(child.block)
                    self._chunks += 1
                    adopted += 1
                elif child.block < 0:
                    # The slot prefilled this chunk fresh while the
                    # node sat host-resident (its payload dropped or
                    # still in flight at match time): adopt the fresh
                    # block — a free promotion back to HBM.
                    child.block = int(block_of(j))
                    self.pool.retain(child.block)
                    self._host_chunks -= 1
                    self.promotions += 1
                    adopted += 1
                child.tick = self._tick
                node = child
        return adopted

    # ----------------------------------------------------------- evict
    def evict_one(self):
        """Evict the LRU unpinned deepest-device node (releasing its
        block back toward the free list). With a spill path wired in,
        the victim is first offered to the host tier: ``"spilled"``
        demotes it (node stays, HOST-resident), ``"dropped"`` destroys
        it like the untiered cache always did — both truthy, so
        admission loops are tier-agnostic. False when everything left
        is pinned or interior — the caller's admission then waits.

        Eligibility is "no device-resident child" rather than "no
        child": a spilled node's descendants are never device-resident
        (residency is a device prefix + host suffix along every path),
        so host children don't shield a block the way cached deeper
        prefixes do."""
        with self._lock:
            victim = None
            stack = list(self._root.children.values())
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if node.block < 0:
                    continue
                if any(c.block >= 0 for c in node.children.values()):
                    continue
                if node.refs <= 0 and (victim is None
                                       or node.tick < victim.tick):
                    victim = node
            if victim is None:
                return False
            if self._spill is not None and self._spill(victim):
                self.pool.release(victim.block)
                victim.block = -1
                self._host_chunks += 1
                self.spills += 1
                _EVICTIONS.labels(outcome="spilled").inc()
                return "spilled"
            # Drop: destroy the node and its (host-resident) subtree —
            # unreachable once the parent is gone — discarding any
            # spilled payloads the subtree still keyed.
            doomed, stack = [], [victim]
            while stack:
                n = stack.pop()
                doomed.append(n)
                stack.extend(n.children.values())
            del victim.parent.children[victim.key]
            self.pool.release(victim.block)
            for n in doomed:
                self._chunks -= 1
                if n.block < 0:
                    self._host_chunks -= 1
                if self.host_pool is not None:
                    self.host_pool.discard(n.path)
            self.drops += 1
            _EVICTIONS.labels(outcome="dropped").inc()
            return "dropped"

    # ------------------------------------------------------------ intro
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "tokens_saved": self.tokens_saved,
                    "zero_copy_hits": self.zero_copy_hits,
                    "chunks": self._chunks,
                    "host_chunks": self._host_chunks,
                    "spills": self.spills,
                    "drops": self.drops,
                    "promotions": self.promotions,
                    "blocks_free": self.pool.free_blocks(),
                    "blocks_total": self.pool.usable_blocks}

    def nodes(self) -> List[_BlockNode]:
        """All resident chunk nodes (tests: refcount/eviction safety)."""
        with self._lock:
            out, stack = [], list(self._root.children.values())
            while stack:
                node = stack.pop()
                out.append(node)
                stack.extend(node.children.values())
            return out
