"""The port's ``beam_search`` (models/generation.py) against the JAX
package's on one converted float32 store on the CPU: token-exact, with
scores within rtol 1e-5, without and with ``eos_id`` and
``length_penalty``; width 1 equals greedy ``generate``; with width =
vocab over two steps it finds the joint argmax by brute force; the
reference's validation."""

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


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these models are small, and beside the other
    test processes of a parallel run torch's default pool oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _convert(jm, jparams):
    fields = {f.name: getattr(jm.config, f.name)
              for f in dataclasses.fields(jm.config)}
    cfg = tt.TransformerConfig(**{**fields, "dtype": torch.float32})
    return tt.Transformer(cfg), params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, cfg, device="cpu")


@pytest.fixture(scope="module")
def pair():
    """A 2-layer GQA float32 LM (vocab 64), both packages."""
    jm = jt.Transformer(jt.TransformerConfig(
        vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64,
        max_seq=32, dtype=jnp.float32))
    jparams = jm.init_params(0)
    return (jm, jparams, *_convert(jm, jparams))


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(0).integers(0, 64, (3, 5)).astype(np.int32)


@pytest.mark.parametrize("width,eos,penalty", [
    (3, None, 0.0), (4, "first", 0.0), (3, "second", 0.6),
    (3, "first", 50.0)])
def test_beam_search_equals_jax(pair, prompt, width, eos, penalty):
    """``eos`` "first" is item 0's first greedy token (its best beam
    finishes at once and freezes), "second" its second one; a penalty of
    50 flips the choice to a full-length beam."""
    jm, jparams, pm, params = pair
    greedy = tg.generate(pm, params, prompt, 2, device="cpu").numpy()
    eos_id = {None: None, "first": int(greedy[0, 0]),
              "second": int(greedy[0, 1])}[eos]
    ref, ref_score = jg.beam_search(jm, jparams, jnp.asarray(prompt), 6,
                                    beam_width=width, eos_id=eos_id,
                                    length_penalty=penalty)
    got, score = tg.beam_search(pm, params, prompt, 6, beam_width=width,
                                eos_id=eos_id, length_penalty=penalty,
                                device="cpu")
    assert got.dtype == torch.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_allclose(score.numpy(), np.asarray(ref_score),
                               rtol=1e-5)
    if eos == "first" and penalty == 0.0:
        assert bool((got[0] == eos_id).all())     # frozen at step 1
    if penalty == 50.0:
        assert int(got[0, 0]) != eos_id


def test_beam_width_one_is_greedy(pair, prompt):
    _, _, pm, params = pair
    greedy = tg.generate(pm, params, prompt, 7, device="cpu")
    beam, scores = tg.beam_search(pm, params, prompt, 7, beam_width=1,
                                  device="cpu")
    assert torch.equal(beam, greedy)
    assert bool(torch.isfinite(scores).all())


def test_beam_search_full_width_finds_joint_argmax(pair, prompt):
    """Width = vocab over two steps is exhaustive: the result is the
    argmax of the joint log-prob over every two-token continuation,
    computed through the full forward."""
    _, _, pm, params = pair
    vocab = pm.config.vocab
    one = torch.from_numpy(prompt[:1])
    out, score = tg.beam_search(pm, params, one, 2, beam_width=vocab,
                                device="cpu")
    with torch.inference_mode():
        lp1 = torch.log_softmax(pm.apply(params, one)[0, -1], -1)
        seqs = torch.cat([one.expand(vocab, -1),
                          torch.arange(vocab, dtype=torch.int32)[:, None]],
                         dim=1)
        lp2 = torch.log_softmax(pm.apply(params, seqs)[:, -1], -1)
    joint = lp1[:, None] + lp2
    best = int(torch.argmax(joint))
    assert tuple(out[0].tolist()) == (best // vocab, best % vocab)
    assert float(score[0]) == pytest.approx(float(joint.max()), rel=1e-4)


def test_beam_search_validation(pair, prompt):
    _, _, pm, params = pair
    for bad in (0, 65):
        with pytest.raises(ValueError, match="beam_width"):
            tg.beam_search(pm, params, prompt, 4, beam_width=bad,
                           device="cpu")
    with pytest.raises(ValueError, match="eos_id"):
        tg.beam_search(pm, params, prompt, 4, eos_id=64, device="cpu")
    with pytest.raises(ValueError, match="max_new_tokens"):
        tg.beam_search(pm, params, prompt, 0, device="cpu")
    learned = tt.Transformer(dataclasses.replace(pm.config,
                                                 pos_emb="learned"))
    with pytest.raises(ValueError, match="max_seq"):
        tg.beam_search(learned, learned.init_params(0, device="cpu"),
                       prompt, 30, device="cpu")
