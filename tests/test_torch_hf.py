"""Hugging Face interop of the port (models/hf.py) and the CLI paths that
use it (``--hf-gpt2`` in generate_main, serve_main and eval_main), on the
CPU.

Ground truth is the torch forward of ``transformers`` GPT-2 and LLaMA
models built in memory from small configs (as tests/test_hf.py): no
network and no downloaded files.  The port's logits agree with it within
rtol 1e-4, atol 1e-4 (tests/test_hf.py:49); the converted stores equal
the JAX package's conversion bit for bit, in f32 and bf16; the exports
round-trip and every refusal holds.  The CLIs read a ``save_pretrained``
directory under tmp_path and take token-id prompts (it has no tokenizer
files); eval_main's JSON line is held against the JAX ``pst-eval`` on
``small_lm`` and ``moe_lm`` (one checkpoint, written from a numpy store,
read by both) and on the converted checkpoint."""

import copy
import io
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from parameter_server_distributed_tpu.cli import \
    eval_main as ref_eval  # noqa: E402
from parameter_server_distributed_tpu.models import hf as jhf  # noqa: E402
from parameter_server_distributed_tpu.models import \
    registry as ref_registry  # noqa: E402
from parameter_server_distributed_tpu_torch.checkpoint import \
    codec  # noqa: E402
from parameter_server_distributed_tpu_torch.cli import (  # noqa: E402
    eval_main, generate_main, serve_main)
from parameter_server_distributed_tpu_torch.models import hf  # noqa: E402
from parameter_server_distributed_tpu_torch.models.generation import \
    generate  # noqa: E402
from parameter_server_distributed_tpu_torch.models.quant import \
    quantize_params  # noqa: E402
from parameter_server_distributed_tpu_torch.models.serving import \
    DecodeServer  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def hygiene(monkeypatch):
    """One torch intra-op thread; the hub client offline (every load
    here is a local directory)."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def gpt2_config(**kw):
    return transformers.GPT2Config(vocab_size=128, n_positions=64, n_embd=32,
                                   n_layer=2, n_head=2, **kw)


def llama_config(**kw):
    return transformers.LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=56,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, **kw)


@pytest.fixture(scope="module")
def gpt2():
    torch.manual_seed(0)
    hf_model = transformers.GPT2LMHeadModel(gpt2_config()).eval()
    model, params = hf.from_hf_gpt2(hf_model, device="cpu")
    return hf_model, model, params


@pytest.fixture(scope="module")
def llama():
    torch.manual_seed(1)
    hf_model = transformers.LlamaForCausalLM(llama_config()).eval()
    model, params = hf.from_hf_llama(hf_model, dtype=torch.float32,
                                     device="cpu")
    return hf_model, model, params


def torch_logits(hf_model, x):
    with torch.no_grad():
        return hf_model(torch.from_numpy(np.asarray(x, np.int64))
                        ).logits.numpy()


def ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 128, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "stacked"])
def test_logits_match_transformers(family, scan, gpt2, llama):
    hf_model = (gpt2 if family == "gpt2" else llama)[0]
    convert = hf.from_hf_gpt2 if family == "gpt2" else hf.from_hf_llama
    model, params = convert(hf_model, dtype=torch.float32, scan_layers=scan,
                            device="cpu")
    assert any(n.startswith("blocks/") for n in params) == scan
    assert list(params) == list(model.param_shapes())
    x = ids(2, (2, 12))
    with torch.no_grad():
        got = model.apply(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, torch_logits(hf_model, x), **TOL)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stores_equal_the_jax_conversion(family, dtype, gpt2, llama):
    hf_model = (gpt2 if family == "gpt2" else llama)[0]
    if dtype == "bf16":
        hf_model = copy.deepcopy(hf_model).to(torch.bfloat16)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    convert = hf.from_hf_gpt2 if family == "gpt2" else hf.from_hf_llama
    ref_convert = (jhf.from_hf_gpt2 if family == "gpt2"
                   else jhf.from_hf_llama)
    model, params = convert(hf_model, dtype=tdt, device="cpu")
    ref_model, ref_params = ref_convert(hf_model, dtype=jdt)
    assert model.config.dtype == tdt
    assert model.param_shapes() == ref_model.param_shapes()
    assert sorted(params) == sorted(ref_params)
    bits = torch.uint16 if dtype == "bf16" else torch.int32
    for name, ref in ref_params.items():
        ref = np.asarray(ref)
        assert params[name].dtype == tdt, name
        assert params[name].view(bits).numpy().tobytes() == \
            ref.view(np.uint16 if dtype == "bf16" else np.int32).tobytes(), \
            name


def test_greedy_generation_and_serving_match_transformers(gpt2, llama):
    """KV-cached greedy decoding of both converted families reproduces
    transformers' greedy continuation, and a DecodeServer over an int8
    GPT-2 store answers (its first token from the prefill agrees)."""
    for hf_model, model, params in (gpt2, llama):
        prompt = ids(3, (1, 6))
        with torch.no_grad():
            want = hf_model.generate(
                torch.from_numpy(prompt.astype(np.int64)), max_new_tokens=8,
                do_sample=False, pad_token_id=0)[0, 6:].numpy()
        got = generate(model, params, prompt, 8, device="cpu")[0].numpy()
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    _, model, params = gpt2
    srv = DecodeServer(model, quantize_params(params), slots=2, max_len=64,
                       cache_dtype="int8", device="cpu")
    prompt = ids(4, 6).tolist()
    rid = srv.submit(prompt, max_new_tokens=5)
    out = srv.run_to_completion()[rid]
    ref = generate(model, params, [prompt], 5, device="cpu")[0].tolist()
    assert len(out) == 5 and out[0] == ref[0]


def test_position_budget_refused(gpt2):
    _, model, params = gpt2
    prompt = ids(5, (1, 62))
    with pytest.raises(ValueError, match="learned-position"):
        generate(model, params, prompt, 5, device="cpu")
    with pytest.raises(ValueError, match="learned-position"):
        model.apply(params, torch.from_numpy(ids(5, (1, 72))))


def test_export_round_trips(gpt2, llama):
    """to_hf_gpt2 and to_hf_llama load into the torch models with logits
    parity; a fine-tuned store exports faithfully (LLaMA) or, where the
    head has untied from wte (GPT-2), is refused until re-tied."""
    x = ids(6, (2, 9))
    for (hf_model, model, params), export in ((gpt2, hf.to_hf_gpt2),
                                              (llama, hf.to_hf_llama)):
        target = copy.deepcopy(hf_model)
        leaves = {n: v.clone().requires_grad_() for n, v in params.items()}
        model.loss(leaves, torch.from_numpy(ids(7, (2, 12)))).backward()
        tuned = {n: (v - 0.01 * v.grad).detach() for n, v in leaves.items()}
        if export is hf.to_hf_gpt2:
            with pytest.raises(ValueError, match="ties lm_head"):
                export(model, tuned)
            tuned["lm_head/w"] = tuned["embed/tok"].T
        target.load_state_dict(export(model, tuned))
        with torch.no_grad():
            want = model.apply(tuned, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(torch_logits(target, x), want, **TOL)


def test_export_layouts_and_guards(llama):
    hf_model, model, params = llama
    stacked_model, stacked = hf.from_hf_llama(hf_model, dtype=torch.float32,
                                              scan_layers=True, device="cpu")
    sd = hf.to_hf_llama(stacked_model, stacked)
    target = copy.deepcopy(hf_model)
    target.load_state_dict(sd)
    for name, value in hf_model.state_dict().items():
        assert torch.equal(sd[name], value), name
    with pytest.raises(ValueError, match="int8-quantized"):
        hf.to_hf_llama(model, quantize_params(params))
    tied = dict(params)
    tied["lm_head/w"] = tied["embed/tok"].T
    assert "lm_head.weight" not in hf.to_hf_llama(model, tied,
                                                  tie_word_embeddings=True)
    with pytest.raises(ValueError, match="diverged"):
        hf.to_hf_llama(model, params, tie_word_embeddings=True)
    torch.manual_seed(2)
    with pytest.raises(ValueError, match="LLaMA architecture"):
        hf.to_hf_llama(*hf.from_hf_gpt2(
            transformers.GPT2LMHeadModel(gpt2_config()), device="cpu"))
    with pytest.raises(ValueError, match="GPT-2 architecture"):
        hf.to_hf_gpt2(model, params)


@pytest.mark.parametrize("kw,needle", [
    (dict(activation_function="gelu"), "activation_function"),
    (dict(scale_attn_by_inverse_layer_idx=True),
     "scale_attn_by_inverse_layer_idx"),
    (dict(reorder_and_upcast_attn=True), "reorder_and_upcast_attn")],
    ids=["gelu", "scale_attn", "reorder_attn"])
def test_gpt2_variants_refused(kw, needle):
    with pytest.raises(ValueError, match=needle):
        hf.config_from_hf_gpt2(gpt2_config(**kw))
    with pytest.raises(ValueError, match=needle):
        jhf.config_from_hf_gpt2(gpt2_config(**kw))


@pytest.mark.parametrize("kw,needle", [
    (dict(rope_scaling={"rope_type": "linear", "factor": 2.0}),
     "rope_scaling"),
    (dict(attention_bias=True), "attention_bias"),
    (dict(hidden_act="gelu"), "hidden_act")],
    ids=["rope_scaling", "attention_bias", "hidden_act"])
def test_llama_variants_refused(kw, needle):
    with pytest.raises(ValueError, match=needle):
        hf.config_from_hf_llama(llama_config(**kw))


def test_n_inner_shape_contract_and_plain_stand_ins():
    """n_inner is honoured; a store missing a tensor is refused by the
    shape contract; and any object with ``.config`` and ``.state_dict()``
    of numpy arrays converts (a host without transformers)."""
    torch.manual_seed(3)
    hf_model = transformers.GPT2LMHeadModel(gpt2_config(n_inner=40))
    model, params = hf.from_hf_gpt2(hf_model, device="cpu")
    assert model.config.d_ff == 40 and params["layer0/mlp/w1"].shape == (
        32, 40)

    class StandIn:
        def __init__(self, config, state):
            self.config, self._state = config, state

        def state_dict(self):
            return self._state

    state = {n: t.numpy() for n, t in hf_model.state_dict().items()}
    _, plain = hf.from_hf_gpt2(StandIn(hf_model.config, state),
                               device="cpu")
    assert all(torch.equal(plain[n], params[n]) for n in params)
    state["transformer.ln_f.bias"] = np.zeros(31, np.float32)
    with pytest.raises(ValueError, match="wrong_shape"):
        hf.from_hf_gpt2(StandIn(hf_model.config, state), device="cpu")


# ---- the CLIs ------------------------------------------------------------

@pytest.fixture(scope="module")
def checkout(tmp_path_factory, gpt2):
    path = tmp_path_factory.mktemp("hf") / "gpt2"
    gpt2[0].save_pretrained(path)
    return str(path)


def hf_greedy(hf_model, prompt, n):
    with torch.no_grad():
        out = hf_model.generate(torch.tensor([prompt]), max_new_tokens=n,
                                do_sample=False, pad_token_id=0)
    return out[0, len(prompt):].tolist()


def test_generate_main_hf_gpt2(checkout, gpt2, capsys):
    prompt = ids(8, 7).tolist()
    assert generate_main.main([
        f"--hf-gpt2={checkout}", f"--tokens={','.join(map(str, prompt))}",
        "--max-new=6", "--device=cpu"]) == 0
    out = capsys.readouterr()
    assert [int(t) for t in out.out.strip().split(",")] == hf_greedy(
        gpt2[0], prompt, 6)
    assert "HF GPT-2 checkpoint" in out.err
    # no tokenizer files: a text prompt is refused
    with pytest.raises(ValueError, match="no tokenizer files"):
        generate_main.main([f"--hf-gpt2={checkout}", "--prompt=hi",
                            "--device=cpu"])


def test_serve_main_hf_gpt2(checkout, gpt2, capsys, monkeypatch):
    prompts = [ids(9, 5).tolist(), ids(10, 9).tolist()]
    monkeypatch.setattr(sys, "stdin", io.StringIO("".join(
        json.dumps({"id": i, "tokens": p, "max_new": 6}) + "\n"
        for i, p in enumerate(prompts))))
    assert serve_main.main([f"--hf-gpt2={checkout}", "--device=cpu",
                            "--slots=2", "--max-len=64"]) == 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines() if line.strip()]
    done = {line["id"]: line["tokens"] for line in lines if line.get("done")}
    assert done == {i: hf_greedy(gpt2[0], p, 6)
                    for i, p in enumerate(prompts)}


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _same_eval(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, float):
            assert got[key] == pytest.approx(value, rel=1e-5), key
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("name", ["small_lm", "moe_lm"])
def test_eval_main_matches_pst_eval(name, tmp_path, capsys):
    """One checkpoint (the JAX init as numpy), the same held-out stream:
    the port's JSON line is pst-eval's (the MoE line carries the note in
    place of a perplexity)."""
    model, _ = ref_registry.get_model_and_batches(name, 2)
    path = str(tmp_path / "params.ckpt")
    codec.save(path, 0, 3, {n: np.array(v, np.float32)
                            for n, v in model.init_params(0).items()})
    flags = [f"--model={name}", f"--ckpt={path}", "--batch=2", "--steps=2"]
    assert ref_eval.main(flags) == 0
    want = _last_json(capsys)
    assert eval_main.main(flags + ["--device=cpu"]) == 0
    got = _last_json(capsys)
    _same_eval(got, want)
    assert ("note" in got) == (name == "moe_lm")
    assert ("perplexity" in got) == (name == "small_lm")


def test_eval_main_hf_gpt2_matches_pst_eval(checkout, capsys):
    flags = [f"--hf-gpt2={checkout}", "--batch=2", "--steps=2"]
    assert ref_eval.main(flags) == 0
    want = _last_json(capsys)
    assert eval_main.main(flags + ["--device=cpu"]) == 0
    got = _last_json(capsys)
    assert got["model"] == f"hf-gpt2:{checkout}"
    _same_eval(got, want)


def test_eval_main_classifier_and_refusals(checkout, capsys):
    assert eval_main.main(["--model=mnist_mlp", "--batch=16", "--steps=2",
                           "--device=cpu"]) == 0
    out = _last_json(capsys)
    assert 0.0 <= out["accuracy"] <= 1.0 and "perplexity" not in out
    for flags, needle in (
            ([f"--hf-gpt2={checkout}", "--model=small_lm"], "defines model"),
            ([f"--hf-gpt2={checkout}", "--lora-alpha=16"], "lora-alpha"),
            ([f"--hf-gpt2={checkout}", "--seq=16"], "fixes seq"),
            (["--ckpt-dir=/x"], "item 8"),
            (["--avg-last=2"], "item 8"),
            (["--bogus=1"], "unknown flag")):
        with pytest.raises(SystemExit, match=needle):
            eval_main.main(flags + ["--device=cpu"])
