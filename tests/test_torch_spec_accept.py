"""The acceptance math of the port's speculative decoding
(models/generation.py) against the JAX package's: ``accept_or_resample``
under one numpy Generator seed, ``_invert_accept_fraction`` and
``optimal_draft_depth`` on grids, ``_greedy_accept`` on numpy logits,
all equal; ``_sampling_accept`` and ``accept_or_resample`` held as
distributions (the JAX package's draws come from ``jax.random``, which
torch cannot reproduce), as tests/test_generation.py holds the
reference's.  No model runs here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu.models import generation as jg
from parameter_server_distributed_tpu_torch.models import generation as tg


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


@pytest.mark.parametrize("vocab,seed", [(4, 0), (4, 1), (16, 2), (64, 3),
                                        (1024, 4)])
def test_accept_or_resample_equals_jax(vocab, seed):
    """The same (p, q, x) and the same Generator state give the same
    token and verdict, draw after draw (each call consumes the stream
    alike, so one divergence would shift every later draw)."""
    rng = np.random.default_rng(100 + seed)
    cases = []
    for _ in range(200):
        p = rng.dirichlet(np.full(vocab, 0.3))
        q = rng.dirichlet(np.full(vocab, 0.3))
        if rng.random() < 0.1:
            q = p.copy()                       # p == q: always accepted
        cases.append((p, q, int(rng.choice(vocab, p=q))))
    ref_rng, port_rng = (np.random.default_rng(seed) for _ in range(2))
    ref = [jg.accept_or_resample(p, q, x, ref_rng) for p, q, x in cases]
    got = [tg.accept_or_resample(p, q, x, port_rng) for p, q, x in cases]
    assert got == ref
    assert {ok for _, ok in got} == {True, False}


def test_accept_or_resample_preserves_target_distribution():
    """Over x ~ q and accept-or-resample, the token is distributed as p
    (the reference's own property, its skewed pair)."""
    rng = np.random.default_rng(0)
    p = np.asarray([0.5, 0.3, 0.15, 0.05])
    q = np.asarray([0.05, 0.15, 0.3, 0.5])
    n = 20000
    counts = np.zeros(4)
    for _ in range(n):
        token, _ = tg.accept_or_resample(p, q, int(rng.choice(4, p=q)), rng)
        counts[token] += 1
    np.testing.assert_allclose(counts / n, p, atol=0.012)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
def test_invert_accept_fraction_equals_jax(k):
    for f in np.linspace(-0.1, 1.1, 61):
        assert tg._invert_accept_fraction(float(f), k) == \
            jg._invert_accept_fraction(float(f), k)
    for p in (0.1, 0.5, 0.9):
        frac = sum(p ** i for i in range(1, k + 1)) / k
        assert tg._invert_accept_fraction(frac, k) == pytest.approx(
            p, abs=1e-6)


@pytest.mark.parametrize("allow_disable", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_optimal_draft_depth_equals_jax(k, allow_disable):
    for frac in (0.0, 0.05, 0.2, 0.36, 0.5, 0.57, 0.8, 0.95, 1.0):
        for k_max in (1, 2, 4, 8):
            for cost in (0.02, 0.1, 1 / 3, 0.5, 1.0):
                for overhead in (0.0, 0.25):
                    assert tg.optimal_draft_depth(
                        frac, k, k_max, cost, overhead, allow_disable) == \
                        jg.optimal_draft_depth(frac, k, k_max, cost,
                                               overhead, allow_disable), (
                        frac, k_max, cost, overhead)


def test_optimal_draft_depth_controller_anchors():
    """The reference's anchors (tests/test_generation.py:705): a perfect
    draft takes the cap, a hopeless one the least depth, the round-4
    regression shape at most 2, a near-free draft deepens."""
    assert tg.optimal_draft_depth(1.0, 2, 8, cost_ratio=0.1) == 8
    assert tg.optimal_draft_depth(0.0, 4, 8, cost_ratio=0.3) == 1
    assert tg.optimal_draft_depth(0.0, 4, 8, cost_ratio=0.3,
                                  allow_disable=True) == 0
    assert tg.optimal_draft_depth(0.36, 4, 4, cost_ratio=1 / 3) <= 2
    assert tg.optimal_draft_depth(0.57, 2, 4, cost_ratio=1 / 3) <= 2
    assert tg.optimal_draft_depth(0.6, 2, 8, cost_ratio=0.02) >= 4


@pytest.mark.parametrize("k", [1, 3, 4])
def test_greedy_accept_equals_jax(k):
    """Verify-block logits with each row's proposals agreeing with the
    argmax for a planted prefix (0..k, so a row may accept all and take
    the bonus), then disagreeing; ties broken alike (first maximum)."""
    rng = np.random.default_rng(k)
    b, vocab = 9, 50
    logits = rng.standard_normal((b, k + 1, vocab)).astype(np.float32)
    logits[0, :, 7] = logits[0, :, 3] = 9.0          # a tie: 3 wins
    g = logits.argmax(-1)
    props = rng.integers(0, vocab, (b, k)).astype(np.int32)
    for row in range(b):
        agree = row % (k + 1)
        props[row, :agree] = g[row, :agree]
        if agree < k and props[row, agree] == g[row, agree]:
            props[row, agree] = (g[row, agree] + 1) % vocab
    ref_m, ref_corr = jg._greedy_accept(jnp.asarray(logits),
                                        jnp.asarray(props))
    m, corr = tg._greedy_accept(torch.from_numpy(logits),
                                torch.from_numpy(props))
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref_m))
    np.testing.assert_array_equal(corr.numpy(), np.asarray(ref_corr))
    assert set(m.tolist()) == set(range(k + 1))


@pytest.mark.parametrize("k", [1, 3])
def test_sampling_accept_preserves_target_distribution(k):
    """Many rows of one verify block: proposals drawn from the draft's
    q_i, then the vectorized rejection.  The first committed token (p_1
    if accepted, else the residual draw) must follow the target's
    softmax at position 0, and a row accepting everything must take its
    bonus from position k: frequencies within 4 sigma."""
    n, vocab = 40000, 5
    rng = np.random.default_rng(k)
    vlogits = torch.from_numpy(rng.standard_normal(
        (1, k + 1, vocab)).astype(np.float32) * 1.5).expand(n, -1, -1)
    qlog = torch.from_numpy(rng.standard_normal(
        (k, vocab)).astype(np.float32) * 1.5)
    gen = torch.Generator().manual_seed(k)
    q_rows = [torch.softmax(qlog[i], -1).expand(n, -1) for i in range(k)]
    props = torch.stack([torch.multinomial(q, 1, generator=gen)[:, 0]
                         for q in q_rows], dim=1).to(torch.int32)
    m, corr = tg._sampling_accept(vlogits, props, q_rows, 1.0, gen)
    first = torch.where(m >= 1, props[:, 0], corr).numpy()
    p0 = torch.softmax(vlogits[0, 0], -1).numpy()
    freq = np.bincount(first, minlength=vocab) / n
    sigma = np.sqrt(p0 * (1 - p0) / n)
    np.testing.assert_array_less(np.abs(freq - p0), 4 * sigma + 1e-3)
    assert 0 < int((m == k).sum()) < n and int((m == 0).sum()) > 0
    # a draft equal to the target accepts every proposal
    same = [torch.softmax(vlogits[:, i], -1) for i in range(k)]
    props = torch.stack([torch.multinomial(q, 1, generator=gen)[:, 0]
                         for q in same], dim=1).to(torch.int32)
    m, corr = tg._sampling_accept(vlogits, props, same, 1.0, gen)
    assert bool((m == k).all())
    bonus = np.bincount(corr.numpy(), minlength=vocab) / n
    pk = torch.softmax(vlogits[0, k], -1).numpy()
    np.testing.assert_array_less(np.abs(bonus - pk),
                                 4 * np.sqrt(pk * (1 - pk) / n) + 1e-3)
