"""The port's speculative decoders (models/generation.py) against the JAX
package's on converted float32 stores on the CPU: a 2-layer GQA target
(vocab 256) and a draft that agrees with it in part (the target's store
plus seeded noise, so rounds accept 0..k proposals and roll back) or
wholly (the target itself).  ``speculative_generate`` (batch 1) and
``speculative_generate_batched`` (``adaptive=False``) are token-exact
against the JAX functions with the same draft store, stat for stat, and
against the target's own greedy ``generate``, in both cache dtypes.  The
adaptive controller stays token-exact and settles where the reference's
property puts it (tests/test_generation.py:733): depth 0 for a random
draft, the cap for the target itself; its memo and clear_depth_memo."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu.models import generation as jg
from parameter_server_distributed_tpu.models import transformer as jt
from parameter_server_distributed_tpu_torch.models import generation as tg
from parameter_server_distributed_tpu_torch.models import transformer as tt
from parameter_server_distributed_tpu_torch.models.convert import \
    params_from_numpy

NEW = 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these models are small, and beside the other
    test processes of a parallel run torch's default pool oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _convert(jm, store):
    fields = {f.name: getattr(jm.config, f.name)
              for f in dataclasses.fields(jm.config)}
    cfg = tt.TransformerConfig(**{**fields, "dtype": torch.float32})
    return tt.Transformer(cfg), params_from_numpy(store, cfg, device="cpu")


@pytest.fixture(scope="module")
def models():
    """name -> (JAX model, JAX store, port model, port store): the
    target, ``near`` (the target's store plus noise of 0.1 of each
    matrix's deviation: accept rate ~0.4) and ``random`` (a 1-layer
    draft of its own: accept rate ~0)."""
    jm = jt.Transformer(jt.TransformerConfig(
        vocab=256, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64,
        max_seq=64, dtype=jnp.float32))
    store = {k: np.asarray(v) for k, v in jm.init_params(0).items()}
    rng = np.random.default_rng(5)
    near = {k: (v + 0.1 * v.std() * rng.standard_normal(v.shape)).astype(
        np.float32) if v.ndim == 2 else v for k, v in store.items()}
    jr = jt.Transformer(jt.TransformerConfig(
        vocab=256, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_seq=64,
        dtype=jnp.float32))
    rstore = {k: np.asarray(v) for k, v in jr.init_params(1).items()}
    out = {}
    for name, (m, s) in {"target": (jm, store), "near": (jm, near),
                         "random": (jr, rstore)}.items():
        out[name] = (m, {k: jnp.asarray(v) for k, v in s.items()},
                     *_convert(m, s))
    return out


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(1)
    return rng.integers(0, 256, (4, 7)).astype(np.int32)


@pytest.fixture(scope="module")
def greedy(models, prompts):
    """The target's own greedy continuations, per cache dtype (the JAX
    package's generate, which the port's equals: test_torch_generation)."""
    jm, jp = models["target"][:2]
    return {cd: np.asarray(jg.generate(jm, jp, jnp.asarray(prompts), NEW,
                                       cache_dtype=cd))
            for cd in ("native", "int8")}


def _draft(models, name):
    return models["target"] if name == "self" else models[name]


STAT_KEYS = ("verify_calls", "draft_accept_rate",
             "tokens_per_target_forward")


@pytest.mark.parametrize("draft", ["near", "self"])
def test_speculative_generate_equals_jax_and_greedy(models, prompts, greedy,
                                                    draft):
    jm, jp, pm, pp = models["target"]
    jd, jdp, pd, pdp = _draft(models, draft)
    one = prompts[:1]
    ref, ref_stats = jg.speculative_generate(jm, jp, jd, jdp,
                                             jnp.asarray(one), NEW,
                                             draft_len=3)
    got, stats = tg.speculative_generate(pm, pp, pd, pdp, one, NEW,
                                         draft_len=3, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), greedy["native"][:1])
    assert {k: stats[k] for k in STAT_KEYS} == \
        {k: ref_stats[k] for k in STAT_KEYS}
    if draft == "self":
        # 16 tokens: the prefill's and 4 fully accepted verify calls
        assert stats["draft_accept_rate"] == 1.0
        assert stats["tokens_per_target_forward"] == pytest.approx(16 / 5)
    else:
        assert 0.0 < stats["draft_accept_rate"] < 1.0


@pytest.mark.parametrize("draft", ["near", "self"])
@pytest.mark.parametrize("cache_dtype", ["native", "int8"])
def test_batched_equals_jax_and_greedy(models, prompts, greedy, cache_dtype,
                                       draft):
    jm, jp, pm, pp = models["target"]
    jd, jdp, pd, pdp = _draft(models, draft)
    ref, ref_stats = jg.speculative_generate_batched(
        jm, jp, jd, jdp, jnp.asarray(prompts), NEW, draft_len=3,
        cache_dtype=cache_dtype)
    got, stats = tg.speculative_generate_batched(
        pm, pp, pd, pdp, prompts, NEW, draft_len=3, cache_dtype=cache_dtype,
        device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), greedy[cache_dtype])
    assert {k: stats[k] for k in STAT_KEYS} == \
        {k: ref_stats[k] for k in STAT_KEYS}
    if draft == "self":
        assert stats["draft_accept_rate"] == 1.0
        assert stats["tokens_per_target_forward"] == pytest.approx(16 / 5)


def test_batch_one_agrees_with_host_loop(models, prompts):
    """The batched decoder at batch 1 is the host loop, token for token
    and in its verify calls (the reference's own cross-check)."""
    _, _, pm, pp = models["target"]
    _, _, pd, pdp = models["near"]
    got, s_dev = tg.speculative_generate_batched(
        pm, pp, pd, pdp, prompts[1:2], NEW, draft_len=3, device="cpu")
    want, s_host = tg.speculative_generate(pm, pp, pd, pdp, prompts[1:2],
                                           NEW, draft_len=3, device="cpu")
    assert torch.equal(got, want)
    assert s_dev["verify_calls"] == s_host["verify_calls"]


def test_speculative_sampling_preserves_distribution():
    """temperature 1: the rounds' accept-or-resample keeps the target's
    distribution.  The second token of many seeded runs (a round's
    product) against its marginal over the first, 4 sigma."""
    target = tt.Transformer(tt.TransformerConfig(
        vocab=8, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_seq=32,
        dtype=torch.float32))
    draft = tt.Transformer(tt.TransformerConfig(
        vocab=8, d_model=8, n_heads=1, n_layers=1, d_ff=16, max_seq=32,
        dtype=torch.float32))
    tparams = target.init_params(0, device="cpu")
    dparams = draft.init_params(3, device="cpu")
    prompt = np.full((64, 4), 2, np.int32)
    counts = np.zeros((2, 8))
    reps = 8
    for seed in range(reps):
        out, stats = tg.speculative_generate_batched(
            target, tparams, draft, dparams, prompt, 2, draft_len=2,
            temperature=1.0, seed=seed, device="cpu")
        for pos in (0, 1):
            counts[pos] += np.bincount(out[:, pos].numpy(), minlength=8)
    n = 64 * reps
    with torch.inference_mode():
        p0 = torch.softmax(target.apply(tparams, torch.from_numpy(
            prompt[:1]))[0, -1], -1).numpy()
        seqs = torch.cat([torch.from_numpy(prompt[:1]).expand(8, -1),
                          torch.arange(8, dtype=torch.int32)[:, None]], 1)
        p1 = p0 @ torch.softmax(target.apply(tparams, seqs)[:, -1],
                                -1).numpy()
    for freq, p in ((counts[0] / n, p0), (counts[1] / n, p1)):
        sigma = np.sqrt(p * (1 - p) / n)
        np.testing.assert_array_less(np.abs(freq - p), 4 * sigma + 0.01)
    # a perfect draft accepts everything at temperature 1 too
    _, stats = tg.speculative_generate(target, tparams, target, tparams,
                                       prompt[:1], 12, draft_len=3,
                                       temperature=1.0, seed=7,
                                       device="cpu")
    assert stats["draft_accept_rate"] == pytest.approx(1.0)


@pytest.mark.parametrize("cache_dtype", ["native", "int8"])
def test_adaptive_token_exact_settles_and_memoizes(models, prompts, greedy,
                                                   cache_dtype):
    """``calibration="model"``: a random draft settles at depth 0 (plain
    greedy segments ran), the target itself at the cap; the second call
    takes the memo; ``"measured"`` (host timing decides) stays
    token-exact whatever it picks; clear_depth_memo drops the pair."""
    _, _, pm, pp = models["target"]
    _, _, pr, prp = models["random"]
    want = greedy[cache_dtype]
    kw = dict(draft_len=4, adaptive=True, draft_cost_ratio=0.3,
              calibration="model", cache_dtype=cache_dtype, device="cpu")
    tg.clear_depth_memo()
    out, stats = tg.speculative_generate_batched(pm, pp, pr, prp, prompts,
                                                 NEW, **kw)
    np.testing.assert_array_equal(out.numpy(), want)
    assert stats["draft_depths"][0] == 2 and 0 in stats["draft_depths"]
    assert stats["draft_depth"] == 0
    out, steady = tg.speculative_generate_batched(pm, pp, pr, prp, prompts,
                                                  NEW, **kw)
    np.testing.assert_array_equal(out.numpy(), want)
    assert steady["draft_depths"] == ["memo"] and steady["draft_depth"] == 0
    assert steady["verify_calls"] == NEW
    out, perfect = tg.speculative_generate_batched(pm, pp, pm, pp, prompts,
                                                   NEW, **kw)
    np.testing.assert_array_equal(out.numpy(), want)
    assert perfect["draft_depth"] == 4
    assert perfect["draft_accept_rate"] == pytest.approx(1.0)
    out, again = tg.speculative_generate_batched(pm, pp, pm, pp, prompts,
                                                 NEW, **kw)
    np.testing.assert_array_equal(out.numpy(), want)
    assert again["draft_depths"] == ["memo"]
    out, measured = tg.speculative_generate_batched(
        pm, pp, pr, prp, prompts, NEW,
        **{**kw, "calibration": "measured"})
    np.testing.assert_array_equal(out.numpy(), want)
    assert measured["draft_depth"] in range(5)
    assert tg.clear_depth_memo(pr) == 2
    assert tg.clear_depth_memo() == 1


def test_speculative_validation(models, prompts):
    _, _, pm, pp = models["target"]
    _, _, pd, pdp = models["near"]
    other = tt.Transformer(dataclasses.replace(pm.config, vocab=64))
    oparams = other.init_params(0, device="cpu")
    for fn in (tg.speculative_generate, tg.speculative_generate_batched):
        with pytest.raises(ValueError, match="vocab mismatch"):
            fn(pm, pp, other, oparams, prompts[:1], 4, device="cpu")
        with pytest.raises(ValueError, match="draft_len must be >= 1"):
            fn(pm, pp, pd, pdp, prompts[:1], 4, draft_len=0, device="cpu")
    with pytest.raises(ValueError, match="batch-1"):
        tg.speculative_generate(pm, pp, pd, pdp, prompts, 4, device="cpu")
    with pytest.raises(ValueError, match="calibration"):
        tg.speculative_generate_batched(pm, pp, pd, pdp, prompts, 4,
                                        adaptive=True, calibration="x",
                                        device="cpu")
