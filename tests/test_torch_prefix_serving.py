"""The PyTorch port's DecodeServer with the radix prefix cache and the
int8 serving stack against the JAX package's DecodeServer on one
converted store, in float32 on the CPU: the cases of
tests/test_serving.py's prompt-cache tests (exact hits with byte-budget
LRU eviction, extension of a cached prompt, the overflow fallback to a
full prefill, interior-prefix reuse, multi-hop extension, the deepest
ancestor winning, the ancestor-path touch) in both cache dtypes and with
int8 weights.  After every request the greedy streams must be
token-exact and the stats (hits, extensions, nodes, bytes, evictions),
the tree's splits and the cached blocks equal, and both prefix
fingerprints advertise those blocks, each package in its own order (the
port's block-major, tests/test_torch_prefix_tree.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu.models import quant as jq
from parameter_server_distributed_tpu.models import serving as js
from parameter_server_distributed_tpu.models import transformer as jt
from parameter_server_distributed_tpu_torch.models import serving as ts
from parameter_server_distributed_tpu_torch.models import transformer as tt
from parameter_server_distributed_tpu_torch.models.prefix_tree import (
    block_hashes, fp_max, unpack_fp)
from parameter_server_distributed_tpu_torch.models.convert import \
    params_from_numpy


@pytest.fixture(autouse=True)
def hygiene():
    """torch on at most two intra-op threads: these tests' products are
    small, and more threads only cost time where workers share cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    jm = jt.Transformer(jt.TransformerConfig(
        vocab=96, d_model=48, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=96,
        max_seq=128, dtype=jnp.float32, mlp_act="swiglu"))
    fields = {f.name: getattr(jm.config, f.name)
              for f in dataclasses.fields(jm.config)}
    cfg = tt.TransformerConfig(**{**fields, "dtype": torch.float32})
    dense = jm.init_params(0)
    stores = {}
    for weights, jparams in (("dense", dense),
                             ("int8", jq.quantize_params(dense))):
        store = {k: (np.asarray(v.q), np.asarray(v.scale))
                 if isinstance(v, jq.QTensor) else np.asarray(v)
                 for k, v in jparams.items()}
        stores[weights] = (jparams, params_from_numpy(store, cfg,
                                                      device="cpu"))
    return jm, tt.Transformer(cfg), stores


def _toks(rng, n):
    return [int(t) for t in rng.integers(0, 96, n)]


def _scripts():
    """name -> (max_len, events); events are ("submit", prompt, n) or
    ("budget", k): the tree's budget set to k rows of the first admitted
    (k <= 0: its bytes now, less 1, then an eviction pass)."""
    rng = np.random.default_rng(7)
    lru = [[i * 7 + 1] + _toks(rng, n) for i, n in enumerate((5, 8, 12))]
    base = _toks(rng, 7)
    ext = base + _toks(rng, 4)
    longer = ext + _toks(rng, 3)
    wide = _toks(rng, 30)
    long_prompt = _toks(rng, 20)
    fork = long_prompt[:13] + [(long_prompt[13] + 1) % 96] + _toks(rng, 5)
    hops = [_toks(rng, 7)]
    for extra in (4, 5, 3):
        hops.append(hops[-1] + _toks(rng, extra))
    mid = base + _toks(rng, 5)
    shared = _toks(rng, 6)
    a = shared + _toks(rng, 4)
    b = shared + [(a[6] + 1) % 96] + _toks(rng, 3)
    other = [(shared[0] + 1) % 96] + _toks(rng, 8)

    def sub(*prompts, n=5):
        return [("submit", p, n) for p in prompts]

    return {
        "lru": (64, sub(lru[0]) + [("budget", 2)]
                + sub(lru[0], lru[1], lru[1], lru[2], lru[0])),
        "extension": (96, sub(base, ext, longer, ext)),
        "overflow": (46, sub(wide, wide + _toks(rng, 10), n=3)),
        "interior": (96, sub(long_prompt, fork, n=4)),
        "multi_hop": (128, sub(*hops, n=4)),
        "deepest": (128, sub(base, mid, mid + _toks(rng, 4), n=3)),
        "ancestor_touch": (96, sub(shared, other, a, b, n=3)
                           + [("budget", 0)] + sub(other, shared, n=3)),
    }


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


def _drive(srv, events):
    """Run the events; after each, the streams so far, the stats, the
    tree's splits and the fingerprint."""
    trace, first_row = [], None
    for event in events:
        tree = srv._prefix_tree
        if event[0] == "budget":
            tree.budget_bytes = (event[1] * first_row if event[1] > 0
                                 else tree.bytes - 1)
            tree.evict_over_budget()
            result = None
        else:
            rid = srv.submit(event[1], max_new_tokens=event[2])
            result = [int(t) for t in srv.run_to_completion()[rid]]
            first_row = first_row or tree.bytes
        trace.append((result, srv.stats, tree.splits,
                      srv.prefix_fingerprint(), tree_blocks(tree)))
    return trace


@pytest.mark.parametrize("case", sorted(_scripts()))
@pytest.mark.parametrize("cache_dtype", ["native", "int8"])
def test_prefix_cache_matches_jax_server(models, monkeypatch, case,
                                         cache_dtype):
    monkeypatch.setenv("PSDT_PREFIX_FP_BLOCK", "4")
    jm, pm, stores = models
    jparams, params = stores["dense"]
    max_len, events = _scripts()[case]
    ref = js.DecodeServer(jm, jparams, slots=2, max_len=max_len,
                          prompt_cache=8, cache_dtype=cache_dtype)
    port = ts.DecodeServer(pm, params, slots=2, max_len=max_len,
                           prompt_cache=8, cache_dtype=cache_dtype,
                           device="cpu")
    want, got = _drive(ref, events), _drive(port, events)
    for step, (w, g) in enumerate(zip(want, got)):
        # the same streams, stats, splits and cached blocks; the
        # fingerprints hold those blocks, each package in its own order
        assert g[:3] == w[:3] and g[4] == w[4], (case, step)
        check_fingerprint_orders(w[4], w[3], g[3], fp_max())
    # every case reached the path it is named after
    final = got[-1][1]
    assert final["prompt_cache_hits"] + final["prefix_hits"] > 0 or \
        case == "overflow"


@pytest.mark.parametrize("case", ["extension", "interior", "lru"])
@pytest.mark.parametrize("cache_dtype", ["native", "int8"])
def test_int8_weights_prefix_cache_matches_jax_server(models, case,
                                                      cache_dtype):
    jm, pm, stores = models
    jparams, params = stores["int8"]
    max_len, events = _scripts()[case]
    ref = js.DecodeServer(jm, jparams, slots=2, max_len=max_len,
                          prompt_cache=8, cache_dtype=cache_dtype)
    port = ts.DecodeServer(pm, params, slots=2, max_len=max_len,
                           prompt_cache=8, cache_dtype=cache_dtype,
                           device="cpu")
    for w, g in zip(_drive(ref, events), _drive(port, events)):
        assert g[:3] == w[:3] and g[4] == w[4]
        check_fingerprint_orders(w[4], w[3], g[3], fp_max())


@pytest.mark.parametrize("weights", ["dense", "int8"])
def test_int8_cache_concurrent_streams_match_jax_server(models, weights):
    """The int8 cache without the prompt cache: concurrent and staggered
    admissions, token-exact against the JAX server."""
    jm, pm, stores = models
    jparams, params = stores[weights]
    rng = np.random.default_rng(11)
    prompts = [_toks(rng, n) for n in (5, 9, 17, 4)]
    outs = []
    for srv in (js.DecodeServer(jm, jparams, slots=2, max_len=64,
                                cache_dtype="int8"),
                ts.DecodeServer(pm, params, slots=2, max_len=64,
                                cache_dtype="int8", device="cpu")):
        rids = [srv.submit(p, max_new_tokens=6) for p in prompts[:2]]
        srv.step()
        srv.step()
        done = dict(srv.run_to_completion())
        rids += [srv.submit(p, max_new_tokens=6) for p in prompts[2:]]
        done.update(srv.run_to_completion())
        outs.append([[int(t) for t in done[r]] for r in rids])
    assert outs[0] == outs[1]


def test_row_bytes_and_cancel(models):
    jm, pm, stores = models
    _, params = stores["dense"]
    row = (torch.zeros(2, 16, 2, 12, dtype=torch.int8),
           torch.zeros(2, 16, 2, 12, dtype=torch.int8),
           torch.ones(2, 16, 2), torch.ones(2, 16, 2))
    assert ts._row_nbytes(row) == 2 * 768 + 2 * 256
    srv = ts.DecodeServer(pm, params, slots=2, max_len=32, device="cpu")
    rid = srv.submit([1, 2, 3], max_new_tokens=8)
    assert srv.active == 1 and srv.cancel(rid) and srv.idle
    assert not srv.cancel(rid)
    assert rid not in srv.finished()
    assert srv.prefix_fingerprint() == b""
