"""The port's wire codecs (rpc/codec.py ``PythonCodec`` and
``NativeCodec``) against the JAX package's two codecs.

Each packed wire dtype (raw f32, bf16, int8, top-k) encodes a fuzz
corpus (rounding ties, quantizer clamp edges, top-k threshold ties,
infinities, signed zeros, subnormals, the quiet NaN of either sign and a
signalling NaN; no NaN for int8, whose scale a NaN makes NaN) to the
same ``Tensor`` bytes under all four codecs, and
every codec decodes every other's bytes to the same f32 bits.  A NaN
whose payload reaches the top 7 mantissa bits is the one input where the
Python codecs (the quiet NaN of its sign, as ``ml_dtypes`` rounds) and
the C++ codecs (``f32_to_bf16`` keeps those bits) part; each pair still
agrees across the packages, which is pinned too.  Also: the top-k
tie-break, a malformed top-k header refused by both port codecs, and the
``rpc.codec.native`` gauge following ``native.set_enabled``."""

import os

import numpy as np
import pytest

from parameter_server_distributed_tpu import native as ref_native
from parameter_server_distributed_tpu.rpc import messages as ref_m
from parameter_server_distributed_tpu_torch import native
from parameter_server_distributed_tpu_torch.obs import stats
from parameter_server_distributed_tpu_torch.rpc import codec
from parameter_server_distributed_tpu_torch.rpc import messages as port_m

PACKED = ("raw", "bf16", "int8", "topk")
# (package, codec): which messages module encodes, which switch selects
CODECS = (("port", "python"), ("port", "native"), ("jax", "python"),
          ("jax", "native"))


def _default() -> bool:
    return os.environ.get("PSDT_NATIVE", "1").lower() not in ("0", "false")


@pytest.fixture(autouse=True)
def switches():
    """Both packages' library switches, restored afterwards; a skip where
    the library cannot be built (the Python codec is then the only one)."""
    native.set_enabled(True)
    ref_native.set_enabled(True)
    try:
        if native.lib() is None or ref_native.lib() is None:
            pytest.skip("the native library cannot be built here (no g++)")
        yield
    finally:
        native.set_enabled(_default())
        ref_native.set_enabled(_default())


def _use(pkg: str, which: str):
    """The messages module of ``pkg`` with its ``which`` codec active."""
    switch = native if pkg == "port" else ref_native
    switch.set_enabled(which == "native")
    return port_m if pkg == "port" else ref_m


def encode(pkg, which, arr, wire, density=0.1) -> bytes:
    m = _use(pkg, which)
    return m.Tensor.from_array("x", arr, wire_dtype=m.WIRE_DTYPE_NAMES[wire],
                               topk_density=density).encode()


def decode(pkg, which, blob) -> np.ndarray:
    return _use(pkg, which).Tensor.decode(blob).to_array()


def corpus():
    rng = np.random.default_rng(11)
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001],
                    np.uint32).view(np.float32)
    return [
        ("empty", np.zeros(0, np.float32)),
        ("scalar", np.float32(1.5).reshape(())),
        ("ones", np.ones(257, np.float32)),
        ("ties", np.repeat(np.float32([3, -3, 1, 3, 2]), 100)),
        ("rne", np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8),
                          1 + 2 ** -9], np.float32)),
        ("normal", (rng.standard_normal(10_007) * 5).astype(np.float32)),
        ("matrix", rng.standard_normal((64, 129)).astype(np.float32)),
        ("subnormal", (rng.standard_normal(1_001) * 1e-40).astype(
            np.float32)),
        ("huge", (rng.standard_normal(501) * 3e38).astype(np.float32)),
        ("specials", np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45,
                               3.4028235e38, 1.0000001, 0.99999994],
                              np.float32)),
        ("halves", rng.integers(-255, 256, 2_001).astype(np.float32) / 2),
        ("nans", np.concatenate([nans, rng.standard_normal(61).astype(
            np.float32)])),
    ]


@pytest.mark.parametrize("wire", PACKED)
def test_four_codecs_encode_the_same_bytes(wire):
    for name, arr in corpus():
        if np.isnan(arr).any() and wire == "int8":
            continue   # a NaN max-abs scale: the int8 cast of NaN is C's
        blobs = {c: encode(*c, arr, wire) for c in CODECS}
        want = blobs[("jax", "python")]
        for c, blob in blobs.items():
            assert blob == want, f"{wire}/{name}: {c} differs"


@pytest.mark.parametrize("wire", PACKED)
def test_each_codec_decodes_every_codecs_bytes(wire):
    for name, arr in corpus():
        if np.isnan(arr).any() and wire == "int8":
            continue   # see test_four_codecs_encode_the_same_bytes
        blob = encode("jax", "python", arr, wire)
        outs = {c: decode(*c, blob) for c in CODECS}
        for enc in CODECS[:2]:   # the port's bytes into every decoder
            outs[("from",) + enc] = decode("jax", "native",
                                           encode(*enc, arr, wire))
        want = outs[("jax", "python")]
        assert want.shape == (np.asarray(arr).shape or (1,))
        for c, got in outs.items():
            assert got.tobytes() == want.tobytes(), f"{wire}/{name}: {c}"


def test_nan_payloads_split_python_from_native_alike_in_both_packages():
    payload = np.array([0x7F812345, 0xFFA00000, 0x7FFFFFFF, 0xFFBFFFFF],
                       np.uint32).view(np.float32)
    for wire in ("bf16", "topk"):
        blobs = {c: encode(*c, payload, wire, density=1.0) for c in CODECS}
        assert blobs[("port", "python")] == blobs[("jax", "python")]
        assert blobs[("port", "native")] == blobs[("jax", "native")]
        assert blobs[("port", "python")] != blobs[("port", "native")]
    bits = codec.bf16_bits(payload)
    np.testing.assert_array_equal(bits, [0x7FC0, 0xFFC0, 0x7FC0, 0xFFC0])


def test_topk_ties_break_by_ascending_index():
    """All-equal magnitudes: the first k indices, whatever the codec
    (the selection is the codec contract, as ``radix_kth_abs``'s
    threshold makes it in C++)."""
    arr = np.array([2.0, -2.0, 2.0, 1.0, -2.0, 2.0, 0.5] * 30, np.float32)
    k = 50
    idx = codec.topk_indices(arr, k)
    abs_ = np.abs(arr)
    assert np.all(abs_[idx] == 2.0)
    np.testing.assert_array_equal(idx, np.nonzero(abs_ == 2.0)[0][:k])
    for which in ("python", "native"):
        dst = bytearray(codec.payload_nbytes(codec.WIRE_TOPK, arr.size, k))
        _use("port", which)
        codec.active_codec().pack_into(codec.WIRE_TOPK, arr, memoryview(dst),
                                       k)
        got = np.frombuffer(bytes(dst), "<u4", count=k, offset=4)
        np.testing.assert_array_equal(got, idx)


def test_malformed_topk_header_is_refused():
    raw = np.array([1000], "<u4").tobytes() + bytes(12)   # k past the end
    for which in ("python", "native"):
        _use("port", which)
        with pytest.raises((ValueError, IndexError)):
            codec.active_codec().unpack(codec.WIRE_TOPK, raw, 64)


def test_active_codec_and_its_gauge_follow_the_switch():
    gauge = stats.gauge("rpc.codec.native")
    native.set_enabled(False)
    assert codec.active_codec().name == "python" and gauge.value == 0.0
    native.set_enabled(True)
    assert codec.active_codec().name == "native" and gauge.value == 1.0
    assert isinstance(codec.active_codec(), codec.NativeCodec)
