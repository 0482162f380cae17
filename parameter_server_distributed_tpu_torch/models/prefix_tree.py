"""Token-level radix tree over cached K/V rows: the port's own copy of
parameter_server_distributed_tpu/models/prefix_tree.py (which imports no
JAX; the port keeps a copy so that it imports nothing of that package).

A radix (compressed trie) over token sequences indexes the prompt
cache of :class:`~.serving.DecodeServer`:

- **lookup** walks edges in O(prompt length) and matches partially into
  an edge, so any shared prefix anywhere in the cache (not just a
  complete previously admitted prompt) seeds the suffix-only extension
  forward (serving ``DecodeServer._extend``);
- **insertion** splits an edge at the divergence point, so later
  requests share at the deepest common token;
- **eviction** is byte-accounted LRU over tree nodes (the
  ``PSDT_PREFIX_CACHE_BYTES`` budget), with a touch bumping the whole
  ancestor path: a hot shared prefix is never evicted out from under its
  live descendants;
- every tree path is summarised into a compact **fingerprint** (chained
  CRC32 at block boundaries) that a decode fleet can heartbeat to a
  router to score cached-prefix overlap.

Rows are opaque handles (:class:`RowRef`) whose byte size the caller
computes.

Why handle inheritance is sound: a cached row's K/V at positions
``[:L]`` is exactly the prefill of its first ``L`` tokens (causal
attention: later positions never influence earlier K/V), so a node
created by splitting an edge at depth ``L`` shares its descendant's row
handle instead of copying device memory; the extension forward masks
positions ``>= L`` and overwrites ``[L:L+suffix]``, the argument that
makes prefill pad positions harmless.  One physical row can back several
nodes; byte accounting is per unique handle, by refcounts.

Thread model: mutation is single-threaded (the decode loop is the only
thread that touches a DecodeServer); other threads read only
:attr:`PrefixTree.fingerprint`, an immutable ``bytes`` snapshot rebuilt
after every mutation and swapped in with one store.
"""

from __future__ import annotations

import os
import zlib
from typing import Any, Iterator

__all__ = [
    "RowRef", "RadixNode", "PrefixTree", "fp_block", "fp_max",
    "block_hashes", "pack_fp", "unpack_fp", "overlap_blocks",
]


def fp_block() -> int:
    """Fingerprint block size in tokens: a path hash is emitted every
    this-many tokens.  Smaller = finer overlap resolution, more hashes."""
    return max(1, int(os.environ.get("PSDT_PREFIX_FP_BLOCK", "16")))


def fp_max() -> int:
    """Cap on fingerprint hashes heartbeated per server (4 bytes each).
    Shallow (shared-system-prompt) blocks are kept first."""
    return max(1, int(os.environ.get("PSDT_PREFIX_FP_MAX", "64")))


def _crc_tokens(tokens, crc: int = 0) -> int:
    """Fold tokens into a running CRC32.  Position-chained: the hash at
    block boundary ``k`` commits to ALL tokens before it, so a match
    implies the whole prefix matches (modulo CRC collisions — fine for a
    routing score, never for correctness)."""
    for t in tokens:
        crc = zlib.crc32(int(t).to_bytes(4, "little", signed=True), crc)
    return crc & 0xFFFFFFFF


def block_hashes(tokens, block: int | None = None) -> list[int]:
    """Chained CRC32 at every ``block``-token boundary of ``tokens`` —
    the router applies this to an incoming prompt and counts how many
    leading boundary hashes a backend's fingerprint holds."""
    block = block or fp_block()
    out: list[int] = []
    crc = 0
    for i, t in enumerate(tokens):
        crc = zlib.crc32(int(t).to_bytes(4, "little", signed=True), crc)
        if (i + 1) % block == 0:
            out.append(crc & 0xFFFFFFFF)
    return out


def pack_fp(hashes) -> bytes:
    """Pack boundary hashes into the wire form (4 LE bytes each)."""
    return b"".join(int(h).to_bytes(4, "little") for h in hashes)


def unpack_fp(blob: bytes) -> frozenset:
    """Wire form back to a membership set (truncated tail bytes from a
    foreign writer are ignored rather than misparsed)."""
    n = len(blob) // 4
    return frozenset(int.from_bytes(blob[4 * i:4 * i + 4], "little")
                     for i in range(n))


def overlap_blocks(prompt_hashes, fp: frozenset) -> int:
    """How many LEADING block boundaries of a prompt a backend already
    holds.  Consecutive-from-the-start because the chained CRC makes a
    boundary hash commit to everything before it: the first missing
    boundary ends the reusable prefix."""
    n = 0
    for h in prompt_hashes:
        if h not in fp:
            break
        n += 1
    return n


class RowRef:
    """One physical cached row (opaque device payload) shared by one or
    more tree nodes; ``nbytes`` is charged to the tree's budget once,
    while ``refs`` nodes point at it."""

    __slots__ = ("row", "nbytes", "refs")

    def __init__(self, row: Any, nbytes: int):
        self.row = row
        self.nbytes = int(nbytes)
        self.refs = 0


class RadixNode:
    """One tree node: ``edge`` tokens from the parent, a target-row
    handle whose first ``depth`` positions are this path's prefill K/V
    (see module docstring on inheritance), optionally a draft-model
    handle (speculative admissions) and the final-position logits
    (``last`` — only nodes admitted as COMPLETE prompts; split-created
    interior nodes have ``last is None`` and exact matches on them
    extend one token instead of replaying)."""

    __slots__ = ("edge", "parent", "children", "handle", "dhandle",
                 "last", "depth", "tick")

    def __init__(self, edge: tuple, parent: "RadixNode | None"):
        self.edge = edge
        self.parent = parent
        self.children: dict[int, RadixNode] = {}
        self.handle: RowRef | None = None
        self.dhandle: RowRef | None = None
        self.last: Any = None
        self.depth = (0 if parent is None else parent.depth) + len(edge)
        self.tick = 0


class PrefixTree:
    """See module docstring.  ``budget_bytes`` bounds the summed size of
    UNIQUE row handles; inserts over budget evict least-recently-touched
    leaves (path-compressing parents left with a single child and no
    complete-prompt payload)."""

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self.root = RadixNode((), None)
        self.bytes = 0          # unique handle bytes currently pinned
        self._tick = 0
        self.nodes = 0          # nodes excluding root
        self.splits = 0         # edge splits performed (obs)
        self.evictions = 0      # nodes evicted (obs)
        self.fingerprint = b""  # immutable snapshot, cross-thread read

    # ------------------------------------------------------------ refcounts
    def _incref(self, ref: RowRef | None) -> None:
        if ref is None:
            return
        if ref.refs == 0:
            self.bytes += ref.nbytes
        ref.refs += 1

    def _decref(self, ref: RowRef | None) -> None:
        if ref is None:
            return
        ref.refs -= 1
        if ref.refs == 0:
            self.bytes -= ref.nbytes

    # -------------------------------------------------------------- lookup
    def lookup(self, tokens) -> tuple[RadixNode, int, bool]:
        """Walk ``tokens`` as deep as the tree matches.  Returns
        ``(node, matched, partial)``: ``matched`` tokens of the prompt
        are covered, and ``node`` is the node whose row handle covers
        them — the exactly-reached node (``partial=False``) or, when the
        walk ended ``matched - node.parent.depth`` tokens INTO an edge,
        the partially-entered child (``partial=True``; its handle's
        first ``matched`` positions are still the prefix K/V, which is
        the whole point of a token-level tree)."""
        node = self.root
        matched = 0
        n = len(tokens)
        while matched < n:
            child = node.children.get(int(tokens[matched]))
            if child is None:
                return node, matched, False
            edge = child.edge
            limit = min(len(edge), n - matched)
            j = 0
            while j < limit and edge[j] == int(tokens[matched + j]):
                j += 1
            matched += j
            if j < len(edge):
                return child, matched, True
            node = child
        return node, matched, False

    def touch(self, node: RadixNode) -> None:
        """LRU-touch ``node`` AND every ancestor: a hit through a deep
        descendant is evidence the whole shared path is hot."""
        self._tick += 1
        while node is not None and node is not self.root:
            node.tick = self._tick
            node = node.parent

    # -------------------------------------------------------------- insert
    def insert(self, tokens, last: Any, handle: RowRef,
               dhandle: RowRef | None = None) -> RadixNode:
        """Admit a COMPLETE prompt: split the partially-matched edge at
        the divergence point (the split node inherits the descendant's
        row handles — no device copy) and attach the remainder as a new
        leaf owning ``handle``/``dhandle``.  Re-admitting an existing
        path fills in its ``last``/missing handles in place.  Caller
        evicts afterwards (:meth:`evict_over_budget`) so the freshly
        admitted row participates in — and by recency survives — the
        LRU pass."""
        tokens = tuple(int(t) for t in tokens)
        node, matched, partial = self.lookup(tokens)
        if partial:
            node = self._split(node, matched - node.parent.depth)
        if matched == len(tokens):
            # existing path re-admitted as a complete prompt (an interior
            # split node, or a k==0-era node gaining its draft row)
            node.last = last
            if node.handle is None:
                self._incref(handle)
                node.handle = handle
            if node.dhandle is None and dhandle is not None:
                self._incref(dhandle)
                node.dhandle = dhandle
        else:
            leaf = RadixNode(tokens[matched:], node)
            leaf.last = last
            self._incref(handle)
            leaf.handle = handle
            if dhandle is not None:
                self._incref(dhandle)
                leaf.dhandle = dhandle
            node.children[leaf.edge[0]] = leaf
            self.nodes += 1
            node = leaf
        self.touch(node)
        self._refingerprint()
        return node

    def _split(self, child: RadixNode, at: int) -> RadixNode:
        """Split ``child``'s edge ``at`` tokens in: the new interior
        node takes the edge head and SHARES the child's row handles
        (first ``depth`` positions of any descendant row are this
        prefix's K/V — causal attention, module docstring)."""
        parent = child.parent
        mid = RadixNode(child.edge[:at], parent)
        self._incref(child.handle)
        mid.handle = child.handle
        self._incref(child.dhandle)
        mid.dhandle = child.dhandle
        mid.tick = child.tick
        parent.children[mid.edge[0]] = mid
        child.edge = child.edge[at:]
        child.parent = mid
        mid.children[child.edge[0]] = child
        self.nodes += 1
        self.splits += 1
        return mid

    # ------------------------------------------------------------ eviction
    def evict_over_budget(self) -> int:
        """Pop least-recently-touched LEAVES until the unique-handle
        byte total fits the budget; returns nodes evicted.  Removing a
        leaf may leave its parent with one child and no complete-prompt
        payload — such parents merge back into their child (path
        compression), shedding their handle references."""
        evicted = 0
        while self.bytes > self.budget_bytes and self.nodes:
            leaf = min(
                (n for n in self._walk() if not n.children),
                key=lambda n: n.tick)
            self._remove_leaf(leaf)
            evicted += 1
        if evicted:
            self.evictions += evicted
            self._refingerprint()
        return evicted

    def _remove_leaf(self, leaf: RadixNode) -> None:
        parent = leaf.parent
        del parent.children[leaf.edge[0]]
        self._decref(leaf.handle)
        self._decref(leaf.dhandle)
        leaf.handle = leaf.dhandle = None
        self.nodes -= 1
        # path-compress: a split-created interior parent that now has a
        # single child and was never admitted as a complete prompt only
        # duplicates its child's handle — merge them
        if (parent is not self.root and parent.last is None
                and len(parent.children) == 1):
            (only,) = parent.children.values()
            only.edge = parent.edge + only.edge
            only.parent = parent.parent
            parent.parent.children[only.edge[0]] = only
            self._decref(parent.handle)
            self._decref(parent.dhandle)
            parent.handle = parent.dhandle = None
            parent.children.clear()
            self.nodes -= 1

    def clear(self) -> None:
        """Drop everything (weight swap: every cached row is stale)."""
        self.root = RadixNode((), None)
        self.bytes = 0
        self.nodes = 0
        self.fingerprint = b""

    # --------------------------------------------------------- fingerprint
    def _walk(self) -> Iterator[RadixNode]:
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def _refingerprint(self) -> None:
        """Rebuild the fingerprint snapshot: chained CRC32 of every
        root-to-position path at block boundaries, block-major: block k
        of every cached path before block k + 1 of any, so under the cap
        every prefix keeps its shallow blocks, however long the prompts
        cached beside it.  (The JAX package's tree takes each node's
        whole edge at once, so a tree that cached long prompts first can
        fill the cap with their deep blocks and advertise nothing of a
        shorter prefix.)"""
        block = fp_block()
        cap = fp_max()
        hashes: list[int] = []
        seen: set[int] = set()
        # cursors at a block boundary: (node, tokens of its edge folded,
        # crc so far); each level folds one more block on every path,
        # forking where a path branches
        level: list[tuple[RadixNode, int, int]] = [
            (c, 0, 0) for c in self.root.children.values()]
        while level and len(hashes) < cap:
            nxt: list[tuple[RadixNode, int, int]] = []
            for start in level:
                stack = [(*start, 0)]
                while stack and len(hashes) < cap:
                    node, off, crc, k = stack.pop()
                    edge = node.edge
                    while k < block and off < len(edge):
                        crc = zlib.crc32(int(edge[off]).to_bytes(
                            4, "little", signed=True), crc)
                        off += 1
                        k += 1
                    if k < block:
                        # the edge ended inside the block: go on into
                        # every child (a leaf ends the path)
                        stack.extend((c, 0, crc, k) for c in
                                     reversed(list(node.children.values())))
                        continue
                    h = crc & 0xFFFFFFFF
                    if h not in seen:
                        seen.add(h)
                        hashes.append(h)
                    nxt.append((node, off, crc))
            level = nxt
        self.fingerprint = pack_fp(hashes)
