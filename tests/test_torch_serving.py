"""Continuous-batching DecodeServer of the PyTorch port
(models/serving.py) against the JAX package's DecodeServer on one
converted store, in float32 on the CPU: greedy streams must be
token-exact, for the cases of tests/test_serving.py (single request,
concurrent requests, staggered admission, slot reuse, early EOS).  Also
one in-process run of the port's serve_main JSONL loop."""

import dataclasses
import io
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu.models import serving as js
from parameter_server_distributed_tpu.models import transformer as jt
from parameter_server_distributed_tpu_torch.cli import serve_main
from parameter_server_distributed_tpu_torch.models import serving as ts
from parameter_server_distributed_tpu_torch.models import transformer as tt
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
def pair():
    jm = jt.Transformer(jt.TransformerConfig(
        vocab=96, d_model=48, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=96,
        max_seq=128, dtype=jnp.float32))
    jparams = jm.init_params(0)
    fields = {f.name: getattr(jm.config, f.name)
              for f in dataclasses.fields(jm.config)}
    cfg = tt.TransformerConfig(**{**fields, "dtype": torch.float32})
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                               cfg, device="cpu")
    return jm, jparams, tt.Transformer(cfg), params


def _servers(pair, slots, **kw):
    jm, jparams, pm, params = pair
    return (js.DecodeServer(jm, jparams, slots=slots, max_len=64, **kw),
            ts.DecodeServer(pm, params, slots=slots, max_len=64,
                            device="cpu", **kw))


def _prompts(seed, *lengths):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, 96, n)) for n in lengths]


def _run(srv, script):
    """Drive one server through a script of ("submit", prompt, n) and
    ("step",) events; returns the results by submission order."""
    rids = []
    results = {}
    for event in script:
        if event[0] == "submit":
            rids.append(srv.submit(event[1], max_new_tokens=event[2]))
        elif event[0] == "drain":
            results.update(srv.run_to_completion())
        else:
            srv.step()
    results.update(srv.run_to_completion())
    return [results[r] for r in rids]


def _scripts():
    single = _prompts(0, 7)
    concurrent = _prompts(1, 5, 9, 17)
    pa, pb = _prompts(2, 6, 11)
    ra, rb = _prompts(3, 20, 4)
    return {
        "single": (4, [("submit", single[0], 6)]),
        "concurrent": (4, [("submit", p, 6) for p in concurrent]),
        "staggered": (2, [("submit", pa, 8), ("step",), ("step",),
                          ("step",), ("submit", pb, 5)]),
        "slot_reuse": (1, [("submit", ra, 5), ("drain",),
                           ("submit", rb, 5)]),
    }


@pytest.mark.parametrize("case", sorted(_scripts()))
def test_greedy_streams_token_exact(pair, case):
    slots, script = _scripts()[case]
    ref, port = _servers(pair, slots)
    assert _run(port, script) == _run(ref, script)


def test_eos_frees_slot_early(pair):
    prompt = _prompts(4, 5)[0]
    ref, _ = _servers(pair, 2)
    full = _run(ref, [("submit", prompt, 8)])[0]
    eos = full[2]
    ref, port = _servers(pair, 2, eos_id=eos)
    got = _run(port, [("submit", prompt, 8)])
    assert got == _run(ref, [("submit", prompt, 8)])
    assert len(got[0]) <= 3 and got[0][-1] == eos
    assert port._free_slot() is not None


def test_out_of_vocab_tokens_rejected(pair):
    _, port = _servers(pair, 1)
    for bad in ([1, 96], [-1, 2]):
        with pytest.raises(ValueError, match="token ids"):
            port.submit(bad, max_new_tokens=2)
    assert port.idle


def test_slot_exhaustion_raises(pair):
    _, port = _servers(pair, 1)
    port.submit([1, 2, 3], max_new_tokens=4)
    with pytest.raises(RuntimeError, match="no free slot"):
        port.submit([4, 5])


def test_step_many_token_exact_vs_step(pair):
    prompts = _prompts(5, 6, 13)
    _, a = _servers(pair, 2)
    _, b = _servers(pair, 2)
    ra = [a.submit(p, max_new_tokens=9) for p in prompts]
    rb = [b.submit(p, max_new_tokens=9) for p in prompts]
    while not b.idle:
        b.step_many(8)
    res_a, res_b = a.run_to_completion(), b.run_to_completion()
    assert [res_a[r] for r in ra] == [res_b[r] for r in rb]
    assert b.stats["requests_completed"] == 2


def test_stats_and_unported_options(pair):
    _, _, pm, params = pair
    srv = ts.DecodeServer(pm, params, slots=2, max_len=64, device="cpu")
    srv.submit([1, 2, 3], max_new_tokens=3)
    srv.run_to_completion()
    assert srv.stats == {"steps": 2, "tokens_emitted": 2,
                         "requests_admitted": 1, "requests_completed": 1,
                         "prefill_tokens": 3, "prompt_tokens": 3}
    # a mesh is not ported; a draft is, and the reference's own check on
    # it holds: its vocab must be the target's
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.DecodeServer(pm, params, slots=1, max_len=16, device="cpu",
                        mesh=object())
    other = tt.Transformer(dataclasses.replace(pm.config, vocab=64))
    with pytest.raises(ValueError, match="vocab mismatch"):
        ts.DecodeServer(pm, params, slots=1, max_len=16, device="cpu",
                        draft=other,
                        draft_params=other.init_params(0, device="cpu"))
    # the int8 cache and the prompt cache are ported
    # (tests/test_torch_prefix_serving.py holds them against the JAX
    # server); the prompt cache adds its keys to the stats
    srv = ts.DecodeServer(pm, params, slots=1, max_len=16, device="cpu",
                          cache_dtype="int8", prompt_cache=4)
    assert srv.stats["prompt_cache_hits"] == 0
    assert srv.stats["prefix_cache_nodes"] == 0


def test_serve_main_jsonl_on_cpu(monkeypatch, capsys):
    requests = [{"id": "a", "tokens": [5, 6, 7], "max_new": 4},
                {"id": "b", "prompt": "hi", "max_new": 3},
                {"id": "c"}, {"id": "d", "tokens": [5000]}]
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "".join(json.dumps(r) + "\n" for r in requests) + "not json\n"))
    assert serve_main.main(["--model=small_lm", "--device=cpu",
                            "--slots=2", "--max-len=64"]) == 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines()]
    done = {line["id"]: line for line in lines if line.get("done")}
    assert set(done) == {"a", "b"}
    assert len(done["a"]["tokens"]) == 4
    assert isinstance(done["b"]["text"], str)
    streamed = [line["token"] for line in lines if line.get("id") == "a"
                and "token" in line]
    assert streamed == done["a"]["tokens"]
    for rid in ("c", "d"):
        assert any(line.get("id") == rid and "error" in line
                   for line in lines)
    assert any("error" in line and "id" not in line for line in lines)


@pytest.mark.parametrize("flags,error,needle", [
    # --draft-model is ported: the case now holds the reference's check
    # of --draft-len (the id keeps the case's name)
    pytest.param("--draft-model=tiny_lm --draft-len=0", ValueError,
                 "draft_len must be >= 1",
                 id="--draft-model=tiny_lm-speculative"),
    # --follow is ported: the case holds the reference's check of a bare
    # --follow (the id keeps the case's name)
    pytest.param("--follow", SystemExit, "explicit value",
                 id="--follow=127.0.0.1:1-not ported"),
    pytest.param("--bogus=1", SystemExit, "unknown flag",
                 id="--bogus=1-unknown flag")])
def test_serve_main_rejects_flags(flags, error, needle):
    with pytest.raises(error, match=needle):
        serve_main.main(["--model=small_lm", "--device=cpu", *flags.split()])


@pytest.mark.parametrize("argv", [
    [], ["small_lm"], ["--slots=2", "x", "--device=cpu"],
    ["--prompt=a=b", "--verbose"], ["--k=", "--k=2", "pos"]])
def test_parse_argv_matches_reference(argv):
    """serve_main's flag parser (the port's copy in config.py) splits
    every argv as the JAX package's does: ``--k=v``, bare ``--k`` as "1",
    the first ``=`` splits, the last repeat wins."""
    from parameter_server_distributed_tpu import config as ref_config
    from parameter_server_distributed_tpu_torch import config

    assert config.parse_argv(argv) == ref_config.parse_argv(argv)


@pytest.mark.parametrize("argv,hint", [(["--max-len"], ""),
                                       (["--slots", "x"], "slot count")])
def test_require_flag_value_matches_reference(argv, hint):
    """A bare value-flag is refused with the reference's message; the
    same flag with a value passes."""
    from parameter_server_distributed_tpu import config as ref_config
    from parameter_server_distributed_tpu_torch import config

    names = ("--max-len", "--slots")
    with pytest.raises(SystemExit) as ref:
        ref_config.require_flag_value(argv, *names, hint=hint)
    with pytest.raises(SystemExit) as got:
        config.require_flag_value(argv, *names, hint=hint)
    assert str(got.value) == str(ref.value)
    config.require_flag_value([a + "=1" if a.startswith("--") else a
                               for a in argv], *names, hint=hint)
