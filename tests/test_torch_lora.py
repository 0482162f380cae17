"""LoRA's serving side in the PyTorch port (models/lora.py) against the
JAX package's models/lora.py (tests/test_lora.py): adapters start at the
base model, ``merge_lora`` of one converted adapter store equals the JAX
merge (rtol 1e-6) and serves logits within rtol/atol 1e-4 of the JAX
adapted model's, the rank comes from the stored factors, the spec
parser and the trainable mask agree; the LoRA training entry points
refuse and name their roadmap item; and the generate CLI merges a LoRA
checkpoint only with ``--lora-alpha``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu.models import lora as jl
from parameter_server_distributed_tpu.models import transformer as jt
from parameter_server_distributed_tpu_torch.checkpoint import codec
from parameter_server_distributed_tpu_torch.cli import generate_main
from parameter_server_distributed_tpu_torch.models import lora as tl
from parameter_server_distributed_tpu_torch.models import transformer as tt


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


def _models(scan=False):
    jm = jt.Transformer(jt.TransformerConfig(
        vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=16,
        dtype=jnp.float32, scan_layers=scan))
    fields = {f.name: getattr(jm.config, f.name)
              for f in dataclasses.fields(jm.config)}
    return jm, tt.Transformer(tt.TransformerConfig(
        **{**fields, "dtype": torch.float32}))


def _adapter_store(jm, rank=4):
    """A JAX adapter store whose B factors are nonzero."""
    params = jl.init_lora(jm.init_params(0), rank=rank, rng=1)
    for i, name in enumerate(sorted(jl.lora_names(params))):
        if name.endswith("/lora_b"):
            params[name] = 0.1 * jax.random.normal(
                jax.random.key(i), params[name].shape, params[name].dtype)
    return params


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "stacked"])
def test_init_starts_at_base_model(scan):
    jm, pm = _models(scan)
    params = pm.init_params(0, device="cpu")
    adapted = tl.init_lora(params, rank=4, rng=1)
    n_targets = 2 if scan else 2 * pm.config.n_layers
    names = tl.lora_names(adapted)
    assert len(names) == 2 * n_targets
    assert sorted(names) == sorted(jl.lora_names(
        jl.init_lora(jm.init_params(0), rank=4, rng=1)))
    for name in names:
        assert adapted[name].shape == tuple(
            jl.init_lora(jm.init_params(0), rank=4)[name].shape)
    tokens = torch.randint(0, 64, (2, 16), generator=torch.Generator()
                           .manual_seed(0))
    merged = tl.merge_lora(adapted)
    assert torch.equal(pm.apply(merged, tokens), pm.apply(params, tokens))


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "stacked"])
def test_merge_matches_jax(scan):
    jm, pm = _models(scan)
    jparams = _adapter_store(jm)
    store = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    merged = tl.merge_lora(store, alpha=8.0)
    ref = jl.merge_lora(jparams, alpha=8.0)
    assert set(merged) == set(ref) and not tl.lora_names(merged)
    for name, value in ref.items():
        np.testing.assert_allclose(merged[name].numpy(), np.asarray(value),
                                   rtol=1e-6, atol=1e-7)
    tokens = np.random.default_rng(0).integers(0, 64, (2, 16)).astype(
        np.int32)
    want = jm.apply(jl._effective(jparams, 8.0), jnp.asarray(tokens))
    got = pm.apply(merged, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    # the rank is read from the factors: rank 2 merges at alpha / 2
    r2 = tl.init_lora(pm.init_params(0, device="cpu"), rank=2, rng=3)
    assert tl.merge_lora(r2)["layer0/attn/wq" if not scan
                             else "blocks/attn/wq"].shape[-2:] == (32, 32)


def test_spec_parsing_mask_and_errors():
    for spec in ("8", "4:32", "2:0.5"):
        assert tl.split_rank_alpha(spec) == jl.split_rank_alpha(spec)
    with pytest.raises(ValueError, match="--lora"):
        tl.split_rank_alpha("abc")
    with pytest.raises(ValueError, match="rank"):
        tl.split_rank_alpha("0")
    with pytest.raises(ValueError, match="no parameters match"):
        tl.init_lora({"w": torch.zeros(4, 4)})
    p = tl.init_lora({"x/attn/wq": torch.zeros(4, 4)}, rank=2)
    assert tl.trainable_mask(p) == {"x/attn/wq": False,
                                    "x/attn/wq/lora_a": True,
                                    "x/attn/wq/lora_b": True}
    for fn in (tl.lora_loss, tl.lora_value_and_grad, tl.freeze_base):
        with pytest.raises(NotImplementedError, match="item 8"):
            fn(None)


def test_generate_cli_merges_lora_checkpoint(tmp_path, capsys,
                                             monkeypatch):
    jm, pm = _models()
    jparams = _adapter_store(jm, rank=2)
    path = str(tmp_path / "lora.ckpt")
    codec.save(path, 1, 7, {k: np.asarray(v, np.float32)
                            for k, v in jparams.items()})
    # the CLI's model is the test's config (no registry name has it)
    monkeypatch.setattr(generate_main, "build_model", lambda flags: pm)
    argv = ["--ckpt=" + path, "--tokens=1,2,3", "--max-new=3",
            "--device=cpu"]
    with pytest.raises(SystemExit, match="lora-alpha"):
        generate_main.main(argv)
    with pytest.raises(SystemExit, match="explicit value"):
        generate_main.main(argv + ["--lora-alpha"])
    assert generate_main.main(argv + ["--lora-alpha=4"]) == 0
    out = capsys.readouterr()
    assert "LoRA merged, alpha 4" in out.err
    ids = [int(t) for t in out.out.strip().splitlines()[-1].split(",")]
    assert len(ids) == 3 and all(0 <= t < 64 for t in ids)
