"""The port's serving CLIs, in process on the CPU: serve_main's and
generate_main's checkpoint, quantization and cache flags against the
JAX package's functions on the same store (a host checkpoint written by
the JAX package's codec: ``--ckpt`` streams token-exact against JAX
``generate``, with ``--quant=int8 --kv-cache=int8`` too), the prompt
cache and fused rounds through serve_main's line protocol, and every
flag still refused naming its roadmap item."""

import io
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from parameter_server_distributed_tpu.checkpoint import codec as ref_codec
from parameter_server_distributed_tpu.models import generation as jg
from parameter_server_distributed_tpu.models import quant as jq
from parameter_server_distributed_tpu.models import transformer as jt
from parameter_server_distributed_tpu_torch.cli import (generate_main,
                                                        serve_main)

PROMPTS = ([5, 6, 7, 8, 9], [5, 6, 7, 8, 9, 10, 11], [40, 41])


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """small_lm's JAX init as a host checkpoint, and the JAX model."""
    jm = jt.small_lm(vocab=1024, seq=256)
    jparams = jm.init_params(0)
    path = str(tmp_path_factory.mktemp("ckpt") / "small.ckpt")
    ref_codec.save(path, 0, 3, {k: np.asarray(v) for k, v in jparams.items()})
    return path, jm, jparams


def _ref_generate(jm, jparams, prompt, n, quant):
    if quant:
        jparams = jq.quantize_params(jparams)
    out = jg.generate(jm, jparams, jnp.asarray([prompt], jnp.int32), n,
                      cache_dtype="int8" if quant else "native")
    return [int(t) for t in np.asarray(out)[0]]


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_generate_main_ckpt_matches_jax(ckpt, capsys, quant):
    path, jm, jparams = ckpt
    argv = ["--model=small_lm", f"--ckpt={path}", "--tokens=5,6,7,8,9",
            "--max-new=6", "--device=cpu"]
    if quant:
        argv += ["--quant=int8", "--kv-cache=int8"]
    assert generate_main.main(argv) == 0
    out = capsys.readouterr()
    got = [int(t) for t in out.out.strip().split(",")]
    assert got == _ref_generate(jm, jparams, PROMPTS[0], 6, quant)
    assert "iter 3" in out.err and ("int8 weights" in out.err) == quant


def _serve(monkeypatch, capsys, argv, requests):
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "".join(json.dumps(r) + "\n" for r in requests)))
    assert serve_main.main(argv) == 0
    out = capsys.readouterr()
    lines = [json.loads(line) for line in out.out.splitlines()]
    stats = json.loads(out.err.split("serving stats: ")[-1].strip())
    return {line["id"]: line["tokens"] for line in lines
            if line.get("done")}, stats


@pytest.mark.parametrize("layout", ["--no-scan-layers", "--scan-layers"])
def test_serve_main_int8_prompt_cache_and_fused_rounds(ckpt, monkeypatch,
                                                       capsys, layout):
    path, jm, jparams = ckpt
    requests = [{"id": i, "tokens": p, "max_new": 6}
                for i, p in enumerate(PROMPTS + (PROMPTS[0],))]
    done, stats = _serve(monkeypatch, capsys, [
        "--model=small_lm", f"--ckpt={path}", "--device=cpu", "--slots=1",
        "--max-len=64", "--quant=int8", "--kv-cache=int8",
        "--prompt-cache=4", "--fused-rounds=4", layout], requests)
    for i, p in enumerate(PROMPTS + (PROMPTS[0],)):
        assert done[i] == _ref_generate(jm, jparams, p, 6, quant=True), i
    # one slot: each request runs alone; the second extends the first,
    # the fourth replays it
    assert stats["prompt_cache_hits"] == 1 and stats["prefix_hits"] == 1
    assert stats["prefix_cache_nodes"] == 3 and stats["steps"] == 20


def _case(flags, error, needle, case_id=None):
    """One refusal case; its id is "<flags>-<needle>" unless named."""
    return pytest.param(flags, error, needle,
                        id=case_id or f"{flags}-{needle}")


# --draft-model, --beam, --length-penalty and --draft-len are ported:
# their cases now hold the reference's own checks of those options (each
# keeps its case's id); the flags still unported refuse naming their item
@pytest.mark.parametrize("flags,error,needle", [
    _case("--ckpt-dir=/x", SystemExit, "item 8"),
    _case("--avg-last=2", SystemExit, "item 8"),
    _case("--hf-gpt2=gpt2", SystemExit, "item 7"),
    _case("--draft-model=mnist_mlp", ValueError, "is not an LM",
          "--draft-model=tiny_lm-speculative"),
    _case("--follow=127.0.0.1:1", SystemExit, "item 12: .*swap_params",
          "--follow=127.0.0.1:1-swap_params"),
    _case("--serve-port=50070", SystemExit, "item 6c: .*fleet registry",
          "--serve-port=50070-fleet registry"),
    _case("--fused-rounds", SystemExit, "explicit value"),
    _case("--lora-alpha", SystemExit, "explicit value"),
    _case("--quant=int4", SystemExit, "takes int8"),
    _case("--kv-cache=fp8", SystemExit, "takes int8")])
def test_serve_main_refusals(flags, error, needle):
    with pytest.raises(error, match=needle):
        serve_main.main(["--model=small_lm", "--device=cpu", *flags.split()])


@pytest.mark.parametrize("flags,error,needle", [
    _case("--beam=4 --draft-model=tiny_lm", ValueError, "does not combine",
          "--beam=4-beam search"),
    _case("--length-penalty=0.6", ValueError, "applies to beam search",
          "--length-penalty=0.6-beam search"),
    _case("--draft-model=mnist_mlp", ValueError, "is not an LM",
          "--draft-model=tiny_lm-item 6"),
    _case("--draft-model=tiny_lm --draft-len=0", ValueError,
          "draft_len must be >= 1", "--draft-len=2-item 6"),
    _case("--ckpt-dir=/x", SystemExit, "item 8"),
    _case("--avg-last=2", SystemExit, "item 8"),
    _case("--hf-gpt2=gpt2", SystemExit, "item 7"),
    _case("--bogus=1", SystemExit, "unknown flag"),
    _case("--quant=int4", SystemExit, "takes int8")])
def test_generate_main_refusals(flags, error, needle):
    with pytest.raises(error, match=needle):
        generate_main.main(["--model=small_lm", "--device=cpu",
                            *flags.split()])


def test_generate_main_text_prompt(capsys):
    assert generate_main.main(["--model=small_lm", "--prompt=hi",
                               "--max-new=4", "--device=cpu",
                               "--quant=int8"]) == 0
    assert isinstance(capsys.readouterr().out, str)
