"""The port's copy of the radix prefix tree
(parameter_server_distributed_tpu_torch/models/prefix_tree.py) through
the cases of tests/test_prefix_tree.py: split inheritance, refcounted
byte accounting, LRU with path compression and the fingerprint's
chaining; then the copy against the JAX package's module (which imports
no JAX) on the same random admissions: equal node, byte, split and
eviction counts, and fingerprints of the same blocks in two orders (the
port's block-major, so the cap keeps every prefix's shallow blocks; the
JAX package's node by node), and a placement at the default cap after
long prompts that only the port's order advertises."""

import os

import pytest

from parameter_server_distributed_tpu_torch.models.prefix_tree import (
    PrefixTree, RowRef, block_hashes, fp_block, fp_max, overlap_blocks,
    pack_fp, unpack_fp)


def tree_blocks(tree) -> dict:
    """Every block boundary hash of the tree's cached paths -> its block
    depth (0 = the first block)."""
    depth: dict = {}
    stack = [(child, list(child.edge))
             for child in tree.root.children.values()]
    while stack:
        node, path = stack.pop()
        for i, h in enumerate(block_hashes(path)):
            depth.setdefault(h, i)
        stack.extend((c, path + list(c.edge))
                     for c in node.children.values())
    return depth


def check_fingerprint_orders(blocks: dict, jax_fp: bytes, port_fp: bytes,
                             cap: int) -> None:
    """The two packages' fingerprints of one tree: both advertise the
    tree's blocks (all of them under the cap), the port's block-major
    (block k of every path before block k + 1 of any, so a capped one
    holds every shallower block), the JAX package's node by node."""
    port = [int.from_bytes(port_fp[i:i + 4], "little")
            for i in range(0, len(port_fp), 4)]
    jax_ = unpack_fp(jax_fp)
    depths = [blocks[h] for h in port]
    assert depths == sorted(depths)
    assert jax_ <= set(blocks)
    if len(port) < cap:
        assert set(port) == set(blocks)
    else:
        assert {h for h, d in blocks.items() if d < depths[-1]} <= set(port)
    if len(jax_) < cap:
        assert jax_ == set(blocks)


def ref(nbytes=100):
    return RowRef(row=object(), nbytes=nbytes)


def test_lookup_matches_partially_into_edge():
    t = PrefixTree(10**9)
    t.insert((1, 2, 3, 4, 5), last="L", handle=ref())
    node, matched, partial = t.lookup((1, 2, 3, 9))
    assert matched == 3 and partial
    # the partially-entered child's handle covers the matched prefix
    assert node.handle is not None and node.depth == 5
    node, matched, partial = t.lookup((7, 7))
    assert matched == 0 and not partial and node is t.root


def test_split_inherits_handle_and_counts_bytes_once():
    t = PrefixTree(10**9)
    r1 = ref(100)
    t.insert((1, 2, 3, 4, 5), last="a", handle=r1)
    assert t.bytes == 100 and t.nodes == 1
    r2 = ref(150)
    t.insert((1, 2, 3, 9, 9), last="b", handle=r2)
    # split at depth 3: interior node SHARES r1 (no copy, no recharge)
    assert t.splits == 1 and t.nodes == 3
    assert t.bytes == 250  # 100 once (refs=2) + 150
    assert r1.refs == 2 and r2.refs == 1
    mid, matched, partial = t.lookup((1, 2, 3))
    assert matched == 3 and not partial
    assert mid.handle is r1 and mid.last is None  # interior, no logits


def test_readmission_fills_last_and_draft_handle():
    t = PrefixTree(10**9)
    t.insert((1, 2, 3, 4), last="a", handle=ref())
    t.insert((1, 2), last="b", handle=ref(30))  # splits; mid gets last
    mid, matched, partial = t.lookup((1, 2))
    assert not partial and mid.last == "b"
    # the mid node inherited the descendant's handle, so the offered
    # 30-byte handle is NOT taken (and not charged)
    assert t.bytes == 100
    d = ref(40)
    t.insert((1, 2), last="b2", handle=ref(5), dhandle=d)
    assert mid.dhandle is d and t.bytes == 140  # draft row attaches


def test_eviction_is_min_tick_leaf_with_path_compression():
    t = PrefixTree(10**9)
    t.insert((1, 2, 3, 4), last="a", handle=ref())
    t.insert((1, 2, 8, 8), last="b", handle=ref())  # split at (1,2)
    t.insert((5, 5), last="c", handle=ref())
    hit, _, _ = t.lookup((1, 2, 3, 4))
    t.touch(hit)                       # a (and its path) is hot
    hit, _, _ = t.lookup((5, 5))
    t.touch(hit)                       # c is hot; b is the LRU victim
    t.budget_bytes = t.bytes - 1       # force one eviction round
    assert t.evict_over_budget() == 1
    node, matched, _ = t.lookup((1, 2, 8, 8))
    assert matched == 2                # b is gone
    # the split-created (1,2) interior had one child left and no last:
    # path compression merged it away
    node, matched, partial = t.lookup((1, 2, 3, 4))
    assert matched == 4 and not partial and node.last == "a"
    assert node.parent is t.root and node.edge == (1, 2, 3, 4)


def test_ancestor_touch_protects_shared_prefix():
    t = PrefixTree(10**9)
    t.insert((1, 2), last="shared", handle=ref())
    t.insert((9, 9), last="cold", handle=ref())
    deep = t.insert((1, 2, 3, 4), last="deep", handle=ref())
    t.touch(deep)  # touching the descendant refreshes the ancestors
    shared, _, _ = t.lookup((1, 2))
    cold, _, _ = t.lookup((9, 9))
    assert shared.tick > cold.tick
    t.budget_bytes = t.bytes - 1
    t.evict_over_budget()
    _, matched, _ = t.lookup((9, 9))
    assert matched == 0                 # the cold entry was the victim
    node, matched, _ = t.lookup((1, 2))
    assert matched == 2 and node.last == "shared"


def test_evict_over_budget_enforces_byte_bound():
    t = PrefixTree(250)
    for i in range(5):
        t.insert((i, i + 1, i + 2), last=i, handle=ref(100))
    assert t.evict_over_budget() == 3
    assert t.bytes <= 250 and t.nodes == 2 and t.evictions == 3
    # the two survivors are the two most recently admitted
    assert {n.last for n in t._walk()} == {3, 4}


def test_refcounts_drop_bytes_only_at_zero():
    t = PrefixTree(10**9)
    r = ref(100)
    t.insert((1, 2, 3, 4), last="a", handle=r)
    t.insert((1, 2, 7, 7), last="b", handle=ref(60))  # mid shares r
    assert r.refs == 2 and t.bytes == 160
    t.insert((1, 2), last="mid", handle=ref(5))  # complete-prompt mid
    # mid already inherited r, so the 5-byte handle is declined
    assert t.bytes == 160
    # evict the deep leaf: r drops to one ref (the mid node), its 100
    # bytes stay charged — and mid survives (last set, no compression)
    leaf, _, _ = t.lookup((1, 2, 3, 4))
    t._remove_leaf(leaf)
    assert r.refs == 1 and t.bytes == 160
    node, matched, partial = t.lookup((1, 2))
    assert matched == 2 and not partial and node.last == "mid"


def test_compression_sheds_inherited_handle():
    t = PrefixTree(10**9)
    r = ref(100)
    t.insert((1, 2, 3, 4), last="a", handle=r)
    t.insert((1, 2, 7, 7), last="b", handle=ref(60))
    # removing the leaf that brought r leaves the split node with one
    # child and no complete-prompt payload: it merges away and releases
    # its inherited reference — r hits zero refs and is uncharged
    leaf, _, _ = t.lookup((1, 2, 3, 4))
    t._remove_leaf(leaf)
    assert r.refs == 0 and t.bytes == 60
    node, matched, partial = t.lookup((1, 2, 7, 7))
    assert matched == 4 and not partial and node.edge == (1, 2, 7, 7)


def test_clear_resets_everything():
    t = PrefixTree(10**9)
    t.insert((1, 2, 3), last="a", handle=ref())
    assert t.fingerprint == b"" or t.nodes  # fp may be empty (short path)
    t.insert(tuple(range(40)), last="b", handle=ref())
    assert t.fingerprint != b""
    t.clear()
    assert t.nodes == 0 and t.bytes == 0 and t.fingerprint == b""
    assert not t.root.children


def test_fingerprint_matches_router_block_hashes(monkeypatch):
    monkeypatch.setenv("PSDT_PREFIX_FP_BLOCK", "4")
    t = PrefixTree(10**9)
    prompt = tuple(range(10))
    t.insert(prompt, last="a", handle=ref())
    fp = unpack_fp(t.fingerprint)
    hashes = block_hashes(prompt)
    assert len(hashes) == 2            # boundaries at 4 and 8 of 10
    assert overlap_blocks(hashes, fp) == 2
    # a prompt diverging inside the first block shares nothing
    other = (99,) + prompt[1:]
    assert overlap_blocks(block_hashes(other), fp) == 0
    # consecutive-from-start: a hole ends the reusable prefix
    assert overlap_blocks([hashes[0], 0xDEAD, hashes[1]], fp) == 1


def test_fingerprint_cap_keeps_shallow_blocks(monkeypatch):
    monkeypatch.setenv("PSDT_PREFIX_FP_BLOCK", "2")
    monkeypatch.setenv("PSDT_PREFIX_FP_MAX", "3")
    t = PrefixTree(10**9)
    t.insert(tuple(range(20)), last="a", handle=ref())
    fp = unpack_fp(t.fingerprint)
    assert len(fp) == 3
    # the SHALLOW boundaries survive the cap (BFS): blocks 1..3, not the
    # deep tail — exactly the shared-system-prompt blocks routing needs
    assert overlap_blocks(block_hashes(tuple(range(20))), fp) == 3


def test_pack_unpack_roundtrip_and_truncation():
    hashes = [0, 1, 0xFFFFFFFF, 12345]
    blob = pack_fp(hashes)
    assert len(blob) == 16
    assert unpack_fp(blob) == frozenset(hashes)
    # a truncated tail from a foreign writer is ignored, not misparsed
    assert unpack_fp(blob[:-2]) == frozenset(hashes[:3])
    assert unpack_fp(b"") == frozenset()


def test_fp_block_env_default():
    assert "PSDT_PREFIX_FP_BLOCK" not in os.environ or True
    assert fp_block() >= 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_copy_matches_the_jax_package_tree(seed, monkeypatch):
    import numpy as np

    from parameter_server_distributed_tpu.models import prefix_tree as ref_pt
    from parameter_server_distributed_tpu_torch.models import \
        prefix_tree as port_pt

    monkeypatch.setenv("PSDT_PREFIX_FP_BLOCK", "3")
    rng = np.random.default_rng(seed)
    trees = [ref_pt.PrefixTree(900), port_pt.PrefixTree(900)]
    shared = tuple(int(t) for t in rng.integers(0, 5, 6))
    for i in range(40):
        n = int(rng.integers(1, 12))
        tail = tuple(int(t) for t in rng.integers(0, 5, n))
        tokens = shared[:int(rng.integers(0, 7))] + tail
        nbytes = int(rng.integers(50, 200))
        touch = rng.random() < 0.3
        for mod, tree in zip((ref_pt, port_pt), trees):
            node, _, _ = tree.lookup(tokens)
            if touch and node is not tree.root:
                tree.touch(node)
            tree.insert(tokens, last=i, handle=mod.RowRef(None, nbytes))
            tree.evict_over_budget()
        a, b = trees
        assert (a.nodes, a.bytes, a.splits, a.evictions) == (
            b.nodes, b.bytes, b.splits, b.evictions)
        # the same blocks, each package in its own order
        blocks = tree_blocks(a)
        assert blocks == tree_blocks(b)
        check_fingerprint_orders(blocks, a.fingerprint, b.fingerprint,
                                 fp_max())


def test_default_cap_advertises_a_prefix_cached_after_long_prompts():
    """At the default block and cap: a tree that cached three 2046-token
    prompts, then a 1024-token prefix.  The JAX package's fingerprint
    fills its 64 hashes with the long prompts' blocks and advertises 0
    of the prefix's; the port's advertises the first 16 blocks of every
    path, so a prompt extending the prefix overlaps it there.  A router
    scoring the two servers (the prefix's holder and a cold one, equal
    free slots) sends that prompt to the holder on the port's
    fingerprint and splits by server id on the JAX one."""
    from parameter_server_distributed_tpu.fleet import router as jrt
    from parameter_server_distributed_tpu.fleet import messages as jfm
    from parameter_server_distributed_tpu.models import prefix_tree as jpt
    from parameter_server_distributed_tpu_torch.fleet import messages as tfm
    from parameter_server_distributed_tpu_torch.fleet import router as trt

    import numpy as np

    assert fp_block() == 16 and fp_max() == 64
    rng = np.random.default_rng(0)
    longs = [tuple(int(t) for t in rng.integers(0, 32000, 2046))
             for _ in range(3)]
    prefix = tuple(int(t) for t in rng.integers(0, 32000, 1024))
    trees = {"jax": jpt.PrefixTree(10**12), "port": PrefixTree(10**12)}
    for side, tree in trees.items():
        row = jpt.RowRef if side == "jax" else RowRef
        for tokens in (*longs, prefix):
            tree.insert(tokens, last=0, handle=row(None, 1))
    prompt = prefix + (5, 6, 7)
    hashes = block_hashes(prompt)
    overlap = {side: overlap_blocks(hashes, unpack_fp(t.fingerprint))
               for side, t in trees.items()}
    assert overlap == {"jax": 0, "port": 16}
    placed = {}
    for side, fm, score in (("jax", jfm, jrt.score_backends),
                            ("port", tfm, trt.score_backends)):
        rows = [fm.FleetEntry(server_id=0, address="h:0", slots=8,
                              free_slots=8, state=fm.MEMBER_ACTIVE),
                fm.FleetEntry(server_id=1, address="h:1", slots=8,
                              free_slots=8, state=fm.MEMBER_ACTIVE,
                              prefix_fp=trees[side].fingerprint)]
        placed[side] = int(score(rows, {}, hashes)[0].server_id)
    assert placed == {"jax": 0, "port": 1}
