"""The port's copy of the paged KV pool bookkeeping
(skypilot_tpu_torch.serve.kv_pool) through the scenarios the JAX package's
tests/test_paged_kv.py and tests/test_kv_tier.py run on its own copy:
block accounting and its errors, the prefix trie's LRU / refcount /
interior protection, the host tier's budget and in-flight protocol, and a
spill / promote cycle through the trie; plus the pool's metric names in
the port's registry."""
import numpy as np
import pytest

from skypilot_tpu_torch.observability import metrics as metrics_lib
from skypilot_tpu_torch.serve import kv_pool


def test_block_pool_accounting_and_errors():
    pool = kv_pool.BlockPool(6, 8)           # block 0 scratch, 5 usable
    assert pool.usable_blocks == 5
    assert pool.blocks_for(1) == 1 and pool.blocks_for(17) == 3
    pool.reserve(3)
    assert pool.available() == 2
    blocks = [pool.alloc() for _ in range(3)]
    assert 0 not in blocks                   # scratch never allocated
    assert pool.available() == 2             # reservation consumed
    pool.retain(blocks[0])
    pool.release(blocks[0])
    assert pool.refcount(blocks[0]) == 1     # still one owner
    pool.release(blocks[0])
    assert pool.refcount(blocks[0]) == 0     # freed
    with pytest.raises(RuntimeError, match="double-release"):
        pool.release(blocks[0])
    with pytest.raises(RuntimeError, match="available"):
        pool.reserve(5)
    pool.release(blocks[1])
    pool.release(blocks[2])
    assert pool.free_blocks() == 5


def _adopt(pool, trie, prompt, n_tokens, chunk=4):
    owned = [pool.alloc(reserved=False) for _ in range(n_tokens // chunk)]
    trie.publish(prompt, n_tokens, lambda j: owned[j])
    for blk in owned:                        # the slot's own ref drops
        pool.release(blk)


def test_paged_trie_lru_refcount_and_interior_protection():
    """LRU leaves go first, pinned nodes are never evicted, and an
    interior chunk outlives fresher leaves until its children are gone."""
    pool = kv_pool.BlockPool(8, 4)
    trie = kv_pool.PagedPrefixCache(pool, chunk=4)
    a, b = list(range(10, 14)), list(range(20, 24))
    _adopt(pool, trie, a + b + [1], 8)       # chain a -> b
    _adopt(pool, trie, list(range(30, 34)) + [1], 4)       # c
    assert trie.stats()["chunks"] == 3
    assert pool.free_blocks() == 7 - 3

    held = trie.match(a + b + [1])
    assert len(held) == 2
    trie.pin(held)
    assert all(n.refs == 1 for n in held)
    assert trie.evict_one()
    keys = {n.key for n in trie.nodes()}
    assert tuple(a) in keys and tuple(b) in keys
    assert tuple(range(30, 34)) not in keys
    assert not trie.evict_one()              # only pinned/interior left
    assert {n.key for n in trie.nodes()} == {tuple(a), tuple(b)}

    trie.unpin(held)
    assert trie.evict_one()                  # leaf b first
    assert {n.key for n in trie.nodes()} == {tuple(a)}
    assert trie.evict_one()                  # then a, now a leaf
    assert pool.free_blocks() == 7


def test_host_block_pool_accounting_budget_and_inflight():
    pool = kv_pool.HostBlockPool(budget_bytes=3 * 64)
    blk = {"k": np.zeros(16, np.float32)}    # 64 bytes per entry
    pool.mark_inflight(("a",))
    assert pool.has(("a",)) and pool.get(("a",)) is None
    pool.put(("a",), dict(blk))
    assert pool.stats()["inflight"] == 0     # landing clears it
    assert pool.get(("a",)) is not None
    assert pool.stats()["rehits"] == 1
    pool.put(("b",), dict(blk))
    pool.put(("c",), dict(blk))
    pool.get(("a",))
    pool.put(("d",), dict(blk))
    assert not pool.has(("b",))
    assert pool.has(("a",)) and pool.has(("c",)) and pool.has(("d",))
    assert pool.stats()["lru_dropped"] == 1
    assert pool.stats()["bytes"] == 3 * 64
    assert not pool.put(("big",), {"k": np.zeros(128, np.float32)})
    assert pool.has(("a",))                  # nothing was evicted
    pool.discard(("a",))
    assert not pool.has(("a",))
    assert pool.stats()["blocks"] == 2


def test_trie_spill_then_promote_through_host_tier():
    """An evicted leaf spills to the host tier (the node stays, host
    resident), a match still reaches it, and promotion hands it a fresh
    device block; the accounting returns to its start."""
    pool = kv_pool.BlockPool(8, 4)
    host = kv_pool.HostBlockPool(budget_bytes=1 << 20)
    spilled = []

    def spill(node):
        spilled.append(node.path)
        host.put(node.path, {"k": np.full(4, node.block, np.float32)})
        return True

    trie = kv_pool.PagedPrefixCache(pool, chunk=4, host_pool=host,
                                    spill=spill)
    prompt = list(range(40, 48)) + [1]
    _adopt(pool, trie, prompt, 8)
    assert trie.evict_one() == "spilled"
    assert trie.evict_one() == "spilled"
    assert pool.free_blocks() == 7 and len(spilled) == 2
    nodes = trie.match(prompt)
    assert len(nodes) == 2 and all(n.block < 0 for n in nodes)
    assert trie.stats()["host_chunks"] == 2
    for node in nodes:
        block = pool.alloc(reserved=False)
        trie.promote(node, block)
        pool.release(block)                  # the trie holds it now
        assert host.get(node.path) is not None
    assert all(n.block > 0 for n in trie.match(prompt))
    assert pool.free_blocks() == 5


def test_pool_metric_names_in_the_port_registry():
    """The engine-side pool metrics keep the JAX package's names, so a
    dashboard reads either replica."""
    kv_pool.BlockPool(4, 4)
    text = metrics_lib.render()
    assert "stpu_engine_kv_pool_evictions_total" in text
