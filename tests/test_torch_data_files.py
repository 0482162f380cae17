"""The port's file-backed data (data/files.py, data/text.py, the
``data_path`` branch of models/registry.py and worker_main's ``--data``)
against the JAX package's.

Files are written under ``tmp_path``: token shards (uint16 ``.bin`` and
uint32 ``.u32``), npz example sets and text corpora.  Each stream gives
the same batches as the JAX package's from one seed, ``encode_file``
writes byte-identical shards, and bad files raise the same exception
types with the same messages.  torch runs on at most two intra-op
threads."""

import os

import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu.data import files as ref_files
from parameter_server_distributed_tpu.data import text as ref_text
from parameter_server_distributed_tpu.models import registry as ref_registry
from parameter_server_distributed_tpu_torch import config as port_config
from parameter_server_distributed_tpu_torch.cli import worker_main
from parameter_server_distributed_tpu_torch.data import files, text
from parameter_server_distributed_tpu_torch.models import registry

CORPUS = ("the quick brown fox jumps over the lazy dog\n" * 40
          + "naïve café — 数据 ✓ " * 30 + "tail")


@pytest.fixture(autouse=True)
def hygiene():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def same_batches(ours, theirs, n: int = 3) -> None:
    for _ in range(n):
        a, b = next(ours), next(theirs)
        for x, y in zip(a, b) if isinstance(a, tuple) else ((a, b),):
            if isinstance(x, torch.Tensor):
                x = x.numpy()
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


def same_error(ours, theirs) -> None:
    """Both calls raise: the same exception type and message."""
    errors = []
    for call in (ours, theirs):
        with pytest.raises(Exception) as info:
            call()
        errors.append(info.value)
    assert type(errors[0]) is type(errors[1])
    assert str(errors[0]) == str(errors[1])


@pytest.fixture
def shards(tmp_path):
    rng = np.random.default_rng(0)
    u16 = tmp_path / "train.bin"
    rng.integers(0, 1000, 5000).astype("<u2").tofile(u16)
    u32 = tmp_path / "train.u32"
    rng.integers(0, 70000, 3000).astype("<u4").tofile(u32)
    return str(u16), str(u32)


def test_token_streams_match_jax(shards):
    u16, u32 = shards
    for path, kw in ((u16, {}), (u16, {"vocab": 1000}), (u32, {}),
                     (u16, {"dtype": "<u2"})):
        same_batches(files.token_stream(path, 4, 64, seed=3, **kw),
                     ref_files.token_stream(path, 4, 64, seed=3, **kw))
    assert files.load_tokens(u32).dtype == np.dtype("<u4")
    # the last full crop is reachable and nothing past it
    small = os.path.join(os.path.dirname(u16), "small.bin")
    np.arange(10, dtype="<u2").tofile(small)
    same_batches(files.token_stream(small, 16, 10, seed=1),
                 ref_files.token_stream(small, 16, 10, seed=1))


def test_token_file_errors_match_jax(tmp_path, shards):
    u16, u32 = shards
    empty = tmp_path / "empty.bin"
    empty.write_bytes(b"")
    huge = tmp_path / "huge.u32"
    np.full(100, 2 ** 31 + 5, "<u4").tofile(huge)
    for args, kw in (((str(tmp_path / "missing.bin"), 2, 8), {}),
                     ((str(empty), 2, 8), {}),
                     ((u16, 2, 10_000), {}),
                     ((u16, 2, 64), {"vocab": 500}),
                     ((str(huge), 2, 8), {})):
        same_error(lambda: next(files.token_stream(*args, **kw)),
                   lambda: next(ref_files.token_stream(*args, **kw)))


def test_npz_stream_and_errors_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    good = str(tmp_path / "set.npz")
    np.savez(good, x=rng.standard_normal((50, 4, 4, 3)).astype(np.float32),
             y=rng.integers(0, 10, 50).astype(np.int32))
    # 50 examples at batch 8: 6 batches an epoch, into the second epoch
    same_batches(files.npz_stream(good, 8, seed=2),
                 ref_files.npz_stream(good, 8, seed=2), n=9)
    same_batches(files.npz_stream(good, 8, seed=2, drop_remainder=False),
                 ref_files.npz_stream(good, 8, seed=2, drop_remainder=False),
                 n=9)
    no_y = str(tmp_path / "no_y.npz")
    np.savez(no_y, x=np.zeros((4, 2)))
    ragged = str(tmp_path / "ragged.npz")
    np.savez(ragged, x=np.zeros((4, 2)), y=np.zeros(3))
    for args in ((str(tmp_path / "missing.npz"), 2), (no_y, 2),
                 (ragged, 2), (good, 64)):
        same_error(lambda: files.npz_stream(*args),
                   lambda: ref_files.npz_stream(*args))


def test_encode_file_shards_are_byte_identical(tmp_path):
    src = tmp_path / "corpus.txt"
    src.write_text(CORPUS, encoding="utf-8")

    class WideTokenizer:
        """A vocabulary past 2^16: uint32 shards."""
        vocab_size = 70_000

        def encode(self, s):
            return [ord(c) * 7 % 70_000 for c in s]

    for tok, kw in ((None, {}), (None, {"chunk_bytes": 17}),
                    (None, {"add_document_tokens": False}),
                    (WideTokenizer(), {"chunk_bytes": 64})):
        ours, theirs = tmp_path / "ours.bin", tmp_path / "theirs.bin"
        n = text.encode_file(str(src), str(ours), tok, **kw)
        assert n == ref_text.encode_file(str(src), str(theirs), tok, **kw)
        assert ours.read_bytes() == theirs.read_bytes()
    assert [p.name for p in tmp_path.iterdir() if ".tmp." in p.name] == []
    # whitespace pieces: the same pieces as the JAX package's
    with open(src, encoding="utf-8") as a, open(src, encoding="utf-8") as b:
        assert list(text._whitespace_chunks(a, 5)) == \
            list(ref_text._whitespace_chunks(b, 5))
    assert text._shard_dtype(258) == ref_text._shard_dtype(258)
    assert text._shard_dtype(70_000) == ref_text._shard_dtype(70_000)

    class BadTokenizer:
        vocab_size = 10

        def encode(self, s):
            return [11] * len(s)

    same_error(lambda: text.encode_file(str(src), str(ours), BadTokenizer()),
               lambda: ref_text.encode_file(str(src), str(theirs),
                                            BadTokenizer()))
    assert [p.name for p in tmp_path.iterdir() if ".tmp." in p.name] == []


def test_text_stream_cache_matches_jax(tmp_path):
    ours_dir, theirs_dir = tmp_path / "a", tmp_path / "b"
    for d in (ours_dir, theirs_dir):
        d.mkdir()
        (d / "corpus.txt").write_text(CORPUS, encoding="utf-8")
    ours = text.text_stream(str(ours_dir / "corpus.txt"), 4, 32, seed=5)
    theirs = ref_text.text_stream(str(theirs_dir / "corpus.txt"), 4, 32,
                                  seed=5)
    same_batches(ours, theirs)
    shard = "corpus.txt.ByteTokenizer258.bin"
    assert (ours_dir / shard).read_bytes() == \
        (theirs_dir / shard).read_bytes()
    # a newer text encodes anew; an older one reuses the cached shard
    cached = ours_dir / shard
    stamp = os.path.getmtime(cached)
    os.utime(ours_dir / "corpus.txt", (stamp - 10, stamp - 10))
    next(text.text_stream(str(ours_dir / "corpus.txt"), 1, 8))
    assert os.path.getmtime(cached) == stamp
    (ours_dir / "corpus.txt").write_text("fresh words " * 20,
                                         encoding="utf-8")
    os.utime(ours_dir / "corpus.txt", (stamp + 10, stamp + 10))
    next(text.text_stream(str(ours_dir / "corpus.txt"), 1, 8))
    assert cached.read_bytes()[2:4] == np.asarray([ord("f")],
                                                  "<u2").tobytes()
    # cache_dir holds the shard instead
    cache = tmp_path / "cache"
    next(text.text_stream(str(ours_dir / "corpus.txt"), 1, 8,
                          cache_dir=str(cache)))
    assert (cache / shard).exists()


def test_registry_data_path_matches_jax(tmp_path, shards):
    u16, _ = shards
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(CORPUS, encoding="utf-8")
    npz = str(tmp_path / "cifar.npz")
    rng = np.random.default_rng(2)
    np.savez(npz, x=rng.standard_normal((20, 32, 32, 3)).astype(np.float32),
             y=rng.integers(0, 10, 20).astype(np.int32))
    for name, path in (("tiny_lm", u16), ("small_lm", str(corpus)),
                       ("resnet18_cifar", npz), ("vit_tiny_cifar", npz),
                       ("mnist_mlp", None)):
        if path is None:
            x = rng.standard_normal((20, 784)).astype(np.float32)
            path = str(tmp_path / "mnist.npz")
            np.savez(path, x=x, y=rng.integers(0, 10, 20).astype(np.int32))
        model, ours = registry.get_model_and_batches(
            name, 4, seed=7, data_path=path, device="cpu")
        _, theirs = ref_registry.get_model_and_batches(name, 4, seed=7,
                                                       data_path=path)
        same_batches(ours, theirs)
    # a vocab too small for the byte tokenizer, and a missing file
    tiny = registry.get_model("tiny_lm")
    assert tiny.config.vocab >= 258
    with pytest.raises(ValueError, match="byte tokenizer"):
        from parameter_server_distributed_tpu_torch.models.transformer \
            import tiny_lm
        registry.lm_batches(tiny_lm(vocab=100, seq=16), 2,
                            data_path=str(corpus), device="cpu")
    same_error(lambda: next(registry.get_model_and_batches(
        "small_lm", 2, data_path=str(tmp_path / "x.bin"), device="cpu")[1]),
        lambda: next(ref_registry.get_model_and_batches(
            "small_lm", 2, data_path=str(tmp_path / "x.bin"))[1]))
    same_error(lambda: registry.get_model_and_batches(
        "resnet18_cifar", 2, data_path=str(tmp_path / "x.npz"),
        device="cpu"),
        lambda: ref_registry.get_model_and_batches(
            "resnet18_cifar", 2, data_path=str(tmp_path / "x.npz")))


def test_worker_main_takes_data_and_image_rows(tmp_path):
    npz = str(tmp_path / "cifar.npz")
    rng = np.random.default_rng(3)
    np.savez(npz, x=rng.standard_normal((12, 32, 32, 3)).astype(np.float32),
             y=rng.integers(0, 10, 12).astype(np.int32))
    for model in ("resnet18_cifar", "resnet50_imagenet", "vit_tiny_cifar",
                  "vit_s16_imagenet"):
        config, _ = worker_main.build_config(
            ["127.0.0.1:1", "2", "3", f"--model={model}", "--batch=4",
             f"--data={npz}", "--dtype=bf16", "--device=cpu"])
        assert (config.model, config.data_path, config.model_dtype) == \
            (model, npz, "bf16")
    config, _ = worker_main.build_config(["127.0.0.1:1", "2", "3"])
    assert config.data_path == ""
    with pytest.raises(SystemExit, match="--data"):
        worker_main.build_config(["127.0.0.1:1", "2", "3", "--data"])
    worker = worker_main.build_worker(port_config.WorkerConfig(
        worker_id=2, model="resnet18_cifar", batch_size=4, data_path=npz,
        device="cpu"))
    try:
        same_batches(worker.batches, ref_files.npz_stream(npz, 4, seed=2))
        assert worker.trainer.model.config.dtype == torch.float32
    finally:
        worker.shutdown()
