"""Speculative continuous batching in the port's DecodeServer
(models/serving.py ``draft=``) on the CPU, float32: greedy streams
token-exact against the port's plain server and the JAX package's
speculative server (the same converted stores, ``adaptive_draft=False``)
in both cache dtypes, without and with the prefix cache, for staggered
admission and slot reuse; prefix reuse in speculative mode (the draft's
row extended from the tree, or backfilled after k = 0); ``step_many``'s
speculative branch; the refusal of per-request temperature; the stats;
the adaptive depth controller and its re-arming; the sampled rounds'
distribution — the cases of tests/test_serving.py:308-760."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu.models import serving as js
from parameter_server_distributed_tpu.models import transformer as jt
from parameter_server_distributed_tpu_torch.models import serving as ts
from parameter_server_distributed_tpu_torch.models import transformer as tt
from parameter_server_distributed_tpu_torch.models.convert import \
    params_from_numpy

VOCAB = 96


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these models are small, and beside the other
    test processes of a parallel run torch's default pool oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def stores():
    """The target (2 layers, GQA) and ``near``, its store plus noise (a
    draft that agrees in part), both as (JAX model, JAX store, port
    model, port store)."""
    jm = jt.Transformer(jt.TransformerConfig(
        vocab=VOCAB, d_model=48, n_heads=4, n_kv_heads=2, n_layers=2,
        d_ff=96, max_seq=128, dtype=jnp.float32))
    store = {k: np.asarray(v) for k, v in jm.init_params(0).items()}
    rng = np.random.default_rng(3)
    near = {k: (v + 0.1 * v.std() * rng.standard_normal(v.shape)).astype(
        np.float32) if v.ndim == 2 else v for k, v in store.items()}
    fields = {f.name: getattr(jm.config, f.name)
              for f in dataclasses.fields(jm.config)}
    cfg = tt.TransformerConfig(**{**fields, "dtype": torch.float32})
    pm = tt.Transformer(cfg)
    return {name: (jm, {k: jnp.asarray(v) for k, v in s.items()}, pm,
                   params_from_numpy(s, cfg, device="cpu"))
            for name, s in (("target", store), ("near", near))}


def _prompts(seed, *lengths):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, VOCAB, n)] for n in lengths]


def _drive(srv, prompts=None):
    """Staggered admission, a round, a second request, drain, slot reuse;
    results in submission order."""
    pa, pb, pc = prompts or _prompts(0, 6, 11, 4)
    ra = srv.submit(pa, max_new_tokens=7)
    srv.step()
    rb = srv.submit(pb, max_new_tokens=5)
    out = dict(srv.run_to_completion())
    rc = srv.submit(pc, max_new_tokens=6)
    out.update(srv.run_to_completion())
    return [[int(t) for t in out[r]] for r in (ra, rb, rc)]


def _port(stores, draft="near", **kw):
    _, _, pm, pp = stores["target"]
    spec = {}
    if draft:
        spec = dict(draft=pm, draft_params=stores[draft][3], draft_len=3,
                    adaptive_draft=False)
    return ts.DecodeServer(pm, pp, slots=2, max_len=64, device="cpu",
                           **{**spec, **kw})


@pytest.mark.parametrize("prompt_cache", [0, 4])
@pytest.mark.parametrize("cache_dtype", ["native", "int8"])
def test_speculative_server_equals_jax_and_plain(stores, cache_dtype,
                                                 prompt_cache):
    jm, jp, _, _ = stores["target"]
    kw = dict(cache_dtype=cache_dtype, prompt_cache=prompt_cache)
    plain = _drive(_port(stores, draft=None, **kw))
    port = _port(stores, **kw)
    got = _drive(port)
    ref_srv = js.DecodeServer(jm, jp, slots=2, max_len=64, draft=jm,
                              draft_params=stores["near"][1], draft_len=3,
                              adaptive_draft=False, **kw)
    assert got == _drive(ref_srv) == plain
    assert 0.0 < port.stats["draft_accept_rate"] < 1.0
    # the reference poisons a never-used lane's draft row (see
    # test_never_used_lane_draft_write_at_minus_one), so its drafts
    # accept less; both of the port's caches drop the write
    draft_keys = {"steps", "draft_accept_rate", "tokens_per_round"}
    assert ({k: v for k, v in port.stats.items() if k not in draft_keys}
            == {k: v for k, v in ref_srv.stats.items()
                if k not in draft_keys})
    assert (port.stats["draft_accept_rate"]
            >= ref_srv.stats["draft_accept_rate"])
    other = _port(stores, cache_dtype=({"native": "int8", "int8": "native"}
                                       [cache_dtype]),
                  prompt_cache=prompt_cache)
    assert _drive(other) == plain
    assert (other.stats["draft_accept_rate"]
            == port.stats["draft_accept_rate"])


@pytest.mark.parametrize("cache_dtype", ["native", "int8"])
def test_never_used_lane_draft_write_at_minus_one(stores, cache_dtype):
    """A lane no request has held sits at draft length 0, so a round's
    draft catch-up block writes it at position -1.  The reference (JAX
    negative-index normalization) and the port's native cache write it
    at max_len - 1, and its second layer's K/V there are NaN (the query
    at -1 sees no position); a later request in that lane multiplies
    them by a zero probability (0 * NaN) and its draft proposes garbage.
    Both of the port's caches drop the write (the native ragged write
    and kv_quantize keep positions in [0, max_len)).  Tokens stay exact:
    the target's verify decides."""
    jm, jp, _, _ = stores["target"]
    ref = js.DecodeServer(jm, jp, slots=2, max_len=64, draft=jm,
                          draft_params=stores["near"][1], draft_len=3,
                          adaptive_draft=False, cache_dtype=cache_dtype)
    port = _port(stores, cache_dtype=cache_dtype)
    for srv in (ref, port):
        srv.submit(_prompts(0, 6)[0], max_new_tokens=7)
        srv.step()
    if cache_dtype == "int8":
        assert np.isnan(np.asarray(ref._d_cache.v_scale)[1, 1, 63]).all()
        assert bool((port._d_cache.v_scale[:, 1, 63] == 1.0).all())
    else:
        assert np.isnan(np.asarray(ref._d_cache.v)[1, 1, 63]).all()
        assert bool((port._d_cache.v[:, 1, 63] == 0).all())
        assert bool((port._d_cache.k[:, 1, 63] == 0).all())


@pytest.mark.parametrize("cache_dtype", ["native", "int8"])
def test_prefix_reuse_in_speculative_mode(stores, cache_dtype):
    """A shared-prefix admission extends both the target's and the
    draft's row from the tree node (no full prefill); a node cached while
    k = 0 carries no draft row, so after re-arming the draft side alone
    prefills in full, and an exact hit on such a node backfills it."""
    base, tail, more = _prompts(1, 6, 3, 3)
    ext = base + tail
    plain = _port(stores, draft=None, cache_dtype=cache_dtype)
    want = {}
    for p in (base, ext, ext + more, base + more, base + more + tail):
        rid = plain.submit(p, max_new_tokens=5)
        want[tuple(p)] = plain.run_to_completion()[rid]
    srv = _port(stores, cache_dtype=cache_dtype, prompt_cache=4)

    def run(p):
        rid = srv.submit(p, max_new_tokens=5)
        assert srv.run_to_completion()[rid] == want[tuple(p)], p

    run(base)
    run(ext)
    assert srv.stats["prefix_hits"] == 1
    assert srv.stats["prefill_tokens"] == len(base) + len(tail)
    node, _, _ = srv._prefix_tree.lookup(tuple(ext))
    assert node.dhandle is not None
    srv._k = 0                 # the controller turned speculation off
    run(ext + more)            # extended without a draft row
    node, _, _ = srv._prefix_tree.lookup(tuple(ext + more))
    assert node.dhandle is None
    srv._k = 3                 # re-armed: the hit backfills the draft row
    run(ext + more)
    assert srv.stats["prompt_cache_hits"] == 1
    node, _, _ = srv._prefix_tree.lookup(tuple(ext + more))
    assert node.dhandle is not None
    srv._k = 0
    run(base + more)           # a new branch at k = 0 ...
    srv._k = 3
    run(base + more + tail)    # ... extended at k = 3: draft prefilled
    assert srv.stats["prefix_hits"] == 4


def test_prompt_cache_speculative_and_int8(stores):
    """The prompt cache composes with a self-draft (accept 1.0) and the
    int8 cache: hits replay token-exact."""
    _, _, pm, pp = stores["target"]
    prompt = _prompts(2, 7)[0]
    plain = _port(stores, draft=None)
    rid = plain.submit(prompt, max_new_tokens=6)
    ref = plain.run_to_completion()[rid]
    for cache_dtype in ("native", "int8"):
        srv = ts.DecodeServer(pm, pp, slots=2, max_len=64, device="cpu",
                              draft=pm, draft_params=pp, draft_len=2,
                              prompt_cache=4, cache_dtype=cache_dtype)
        first = None
        for hits in (0, 1):
            rid = srv.submit(prompt, max_new_tokens=6)
            got = srv.run_to_completion()[rid]
            first = first or got
            assert got == first and srv.stats["prompt_cache_hits"] == hits
        if cache_dtype == "native":
            assert first == ref
        assert srv.stats["draft_accept_rate"] == 1.0


def test_step_many_speculative_branch_and_stats(stores):
    """step_many with a draft runs one speculative round a call (the depth
    controller decides between rounds): the step() loop's tokens and
    rounds.  A self-draft at k = 3 accepts everything: 7 round-made
    tokens over 2 rounds (4, then 3 to the limit)."""
    _, _, pm, pp = stores["target"]
    prompt = _prompts(3, 5)[0]

    def run(fused):
        srv = ts.DecodeServer(pm, pp, slots=1, max_len=96, device="cpu",
                              draft=pm, draft_params=pp, draft_len=3,
                              adaptive_draft=False)
        rid = srv.submit(prompt, max_new_tokens=8)
        while not srv.idle:
            srv.step_many(4) if fused else srv.step()
        return srv.result(rid), srv.stats

    (a, sa), (b, sb) = run(True), run(False)
    assert a == b and sa == sb
    assert sa["draft_accept_rate"] == 1.0 and sa["steps"] == 2
    assert sa["tokens_per_round"] == 3.5 and sa["draft_depth"] == 3


def test_speculative_server_validation(stores):
    _, _, pm, pp = stores["target"]
    dp = stores["near"][3]
    srv = _port(stores)
    with pytest.raises(ValueError, match="per-request temperature"):
        srv.submit([1, 2, 3], temperature=0.7)
    rid = srv.submit([1, 2, 3], max_new_tokens=4, temperature=0.0)
    assert rid in srv.run_to_completion()
    with pytest.raises(ValueError, match="speculative slack"):
        srv.submit(list(range(50)), max_new_tokens=11)
    with pytest.raises(ValueError, match="top_k/top_p"):
        ts.DecodeServer(pm, pp, slots=1, max_len=64, device="cpu",
                        top_k=5, draft=pm, draft_params=dp)
    with pytest.raises(ValueError, match="draft_params"):
        ts.DecodeServer(pm, pp, slots=1, max_len=64, device="cpu", draft=pm)
    with pytest.raises(ValueError, match="draft_len"):
        ts.DecodeServer(pm, pp, slots=1, max_len=64, device="cpu", draft=pm,
                        draft_params=dp, draft_len=0)


def test_adaptive_depth_follows_acceptance_and_rearms(stores):
    """adaptive_draft: the target itself deepens to the cap, a random
    draft drops to k = 0 (plain rounds), a pinned server keeps its depth;
    all token-exact against the plain server.  After 64 plain rounds an
    idle admission re-arms speculation at depth 1."""
    _, _, pm, pp = stores["target"]
    junk = tt.Transformer(dataclasses.replace(pm.config, n_layers=1))
    jparams = junk.init_params(99, device="cpu")
    prompts = _prompts(4, 5, 5, 5, 5, 5, 5)

    def run(**kw):
        srv = ts.DecodeServer(pm, pp, slots=2, max_len=64, device="cpu",
                              **kw)
        pending = list(prompts)
        while pending or not srv.idle:
            while pending and srv.has_free_slot:
                srv.submit(pending.pop(0), max_new_tokens=24)
            srv.step()
        return srv, [srv.result(r) for r in range(len(prompts))]

    _, want = run()
    perfect, got = run(draft=pm, draft_params=pp, draft_len=4,
                       adaptive_draft=True, draft_cost_ratio=0.3)
    assert got == want and perfect.stats["draft_depth"] == 4
    junky, got = run(draft=junk, draft_params=jparams, draft_len=4,
                     adaptive_draft=True, draft_cost_ratio=0.3)
    assert got == want and junky.stats["draft_depth"] == 0
    pinned, got = run(draft=junk, draft_params=jparams, draft_len=3,
                      adaptive_draft=False)
    assert got == want and pinned.stats["draft_depth"] == 3
    # re-arming: below the threshold of plain rounds at k = 0 an idle
    # admission stays plain; past it, it probes again at depth 1
    junky._plain_rounds = junky._REPROBE_AFTER_PLAIN - 1
    rid = junky.submit(prompts[0], max_new_tokens=4)
    assert junky._k == 0
    junky.run_to_completion()
    assert junky._plain_rounds >= junky._REPROBE_AFTER_PLAIN
    rid = junky.submit(prompts[1], max_new_tokens=8)
    assert junky._k == 1 and junky._accept_ema is None
    assert junky.run_to_completion()[rid] == want[1][:8]


def test_speculative_serving_sampling_preserves_distribution():
    """temperature 1: the first token (submit's draw) and the second (a
    round's accept-or-resample) of many seeded servers follow the
    target's softmax and its marginal over the first token, 4 sigma."""
    target = tt.Transformer(tt.TransformerConfig(
        vocab=8, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_seq=64,
        dtype=torch.float32))
    draft = tt.Transformer(tt.TransformerConfig(
        vocab=8, d_model=8, n_heads=1, n_layers=1, d_ff=16, max_seq=64,
        dtype=torch.float32))
    tparams = target.init_params(0, device="cpu")
    dparams = draft.init_params(3, device="cpu")
    prompt = [2, 2, 2, 2]
    counts = np.zeros((2, 8))
    reps, slots = 48, 8
    for seed in range(reps):
        srv = ts.DecodeServer(target, tparams, slots=slots, max_len=32,
                              temperature=1.0, seed=seed, draft=draft,
                              draft_params=dparams, draft_len=2,
                              device="cpu")
        rids = [srv.submit(prompt, max_new_tokens=2) for _ in range(slots)]
        out = srv.run_to_completion()
        for rid in rids:
            counts[0, out[rid][0]] += 1
            counts[1, out[rid][1]] += 1
    n = reps * slots
    with torch.inference_mode():
        p0 = torch.softmax(target.apply(tparams, torch.tensor(
            [prompt]))[0, -1], -1).numpy()
        seqs = torch.tensor([prompt + [i] for i in range(8)])
        p1 = p0 @ torch.softmax(target.apply(tparams, seqs)[:, -1],
                                -1).numpy()
    for freq, p in ((counts[0] / n, p0), (counts[1] / n, p1)):
        sigma = np.sqrt(p * (1 - p) / n)
        np.testing.assert_array_less(np.abs(freq - p), 4 * sigma + 0.01)
