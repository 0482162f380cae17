"""The port's CLIs with the speculative and beam flags, in process on the
CPU: generate_main ``--beam`` and ``--draft-model`` (the draft's weights
from ``--draft-ckpt``) print what the JAX package's generate_main prints
for the same host checkpoints, and the speculative streams equal plain
greedy decoding (also with ``--adaptive-draft`` and the int8 cache);
serve_main ``--draft-model`` follows the multi-token round protocol of
tests/test_serve_cli.py:94 (a self-draft commits several tokens a round
and requests finish mid-round: every token streamed once, in order, and
a done line a request)."""

import io
import json
import sys

import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu.checkpoint import codec as ref_codec
from parameter_server_distributed_tpu.cli import generate_main as ref_main
from parameter_server_distributed_tpu.models import transformer as jt
from parameter_server_distributed_tpu_torch.cli import (generate_main,
                                                        serve_main)


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
def ckpts(tmp_path_factory):
    """small_lm's and tiny_lm's JAX inits as host checkpoints."""
    out = {}
    for name, model in (("small_lm", jt.small_lm(vocab=1024, seq=256)),
                        ("tiny_lm", jt.tiny_lm(vocab=1024, seq=256))):
        path = str(tmp_path_factory.mktemp("ckpt") / f"{name}.ckpt")
        ref_codec.save(path, 0, 3, {k: np.asarray(v) for k, v in
                                    model.init_params(0).items()})
        out[name] = path
    return out


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out.strip()


@pytest.mark.parametrize("mode", ["--tokens=5,6,7,8,9", "--prompt=the ps"])
def test_generate_main_beam_equals_jax(ckpts, capsys, mode):
    argv = ["--model=small_lm", f"--ckpt={ckpts['small_lm']}", mode,
            "--max-new=6", "--beam=3"]
    want = _run(ref_main.main, argv, capsys)
    assert _run(generate_main.main, argv + ["--device=cpu"], capsys) == want
    penalty = argv + ["--length-penalty=0.6"]
    assert (_run(generate_main.main, penalty + ["--device=cpu"], capsys)
            == _run(ref_main.main, penalty, capsys))


def test_generate_main_draft_equals_jax_and_greedy(ckpts, capsys):
    base = ["--model=small_lm", f"--ckpt={ckpts['small_lm']}",
            "--tokens=5,6,7", "--max-new=8"]
    spec = base + ["--draft-model=tiny_lm",
                   f"--draft-ckpt={ckpts['tiny_lm']}", "--draft-len=3"]
    greedy = _run(generate_main.main, base + ["--device=cpu"], capsys)
    want = _run(ref_main.main, spec, capsys)
    assert want == greedy
    assert generate_main.main(spec + ["--device=cpu"]) == 0
    out = capsys.readouterr()
    assert out.out.strip() == want and "draft params: host checkpoint" \
        in out.err and "accept rate" in out.err
    assert generate_main.main(spec + ["--device=cpu", "--adaptive-draft",
                                      "--draft-cost-ratio=0.3"]) == 0
    out = capsys.readouterr()
    assert out.out.strip() == greedy and "settled depth" in out.err
    # the int8 cache: the speculative stream is int8 greedy decoding's
    int8 = ["--device=cpu", "--kv-cache=int8"]
    assert (_run(generate_main.main, spec + int8, capsys)
            == _run(generate_main.main, base + int8, capsys))


def _serve(monkeypatch, capsys, argv, requests):
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "".join(json.dumps(r) + "\n" for r in requests)))
    assert serve_main.main(argv) == 0
    out = capsys.readouterr()
    lines = [json.loads(line) for line in out.out.splitlines()]
    stats = json.loads(out.err.split("serving stats: ")[-1].strip())
    return lines, stats


def test_serve_main_draft_multi_token_rounds(monkeypatch, capsys):
    requests = [{"id": "a", "tokens": [1, 2, 3], "max_new": 9},
                {"id": "b", "tokens": [4, 5], "max_new": 7}]
    base = ["--model=tiny_lm", "--device=cpu", "--slots=2", "--max-len=48"]
    lines, stats = _serve(monkeypatch, capsys, base + [
        "--draft-model=tiny_lm", "--draft-seed=0", "--draft-len=4",
        "--no-adaptive-draft"], requests)
    streamed: dict = {}
    for line in lines:
        if "token" in line:
            streamed.setdefault(line["id"], []).append(line["token"])
    done = {line["id"]: line["tokens"] for line in lines if line.get("done")}
    assert set(done) == {"a", "b"}
    for req in requests:
        assert streamed[req["id"]] == done[req["id"]]
        assert len(done[req["id"]]) == req["max_new"]
    # a self-draft accepts every proposal: 8 tokens of "a" after its
    # prefill's in 2 rounds (5, then 3 to the limit)
    assert stats["draft_accept_rate"] == 1.0 and stats["steps"] == 2
    assert stats["draft_depth"] == 4
    plain, _ = _serve(monkeypatch, capsys, base, requests)
    assert {line["id"]: line["tokens"] for line in plain
            if line.get("done")} == done
