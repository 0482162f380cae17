"""The port's host C++ library (parameter_server_distributed_tpu_torch/
native/) against numpy and against the JAX package's library.

- Every function gives numpy's bits computed in the C++'s order of f32
  operations, and the JAX package's library's bits, on the same inputs
  (the two libraries are one source, built apart).
- The host optimizers and the buffered close call it where the
  reference's do: each host rule's apply, with both libraries on, is the
  reference's bit for bit, and with both off the reference's numpy path
  bit for bit.
- Two processes building at once into one directory leave one whole,
  loadable library and no temporary file; a g++ that refuses
  -march=native builds the plain flags under their own name and leaves
  no temporary file; ``PSDT_NATIVE=0`` resolves no
  library and the Python codec; a failed build is retried after
  ``set_enabled(True)``.

Skipped where g++ cannot build the library (the port then runs numpy,
which the other tests cover)."""

import ctypes
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from parameter_server_distributed_tpu import native as ref_native
from parameter_server_distributed_tpu.core import optimizer as ref_opt
from parameter_server_distributed_tpu.core import ps_core as ref_core
from parameter_server_distributed_tpu_torch import native
from parameter_server_distributed_tpu_torch.core import optimizer as port_opt
from parameter_server_distributed_tpu_torch.core import ps_core

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = np.float32


def _default() -> bool:
    return os.environ.get("PSDT_NATIVE", "1").lower() not in ("0", "false")


@pytest.fixture
def libs():
    """Both libraries on, or a skip without a compiler; both packages'
    switches restored afterwards."""
    native.set_enabled(True)
    ref_native.set_enabled(True)
    try:
        if native.lib() is None or ref_native.lib() is None:
            pytest.skip("the native library cannot be built here (no g++)")
        yield native.lib(), ref_native.lib()
    finally:
        native.set_enabled(_default())
        ref_native.set_enabled(_default())


def _arrays(n=1031, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 3).astype(F32) for _ in range(4)]


def _ptrs(arrays):
    fp = ctypes.POINTER(ctypes.c_float)
    return (fp * len(arrays))(*[a.ctypes.data_as(fp) for a in arrays])


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


@pytest.mark.parametrize("count", [1, 2, 3])
def test_mean_and_mean_sgd(libs, count):
    port, ref = libs
    srcs = _arrays()[:count]
    acc = srcs[0].copy()
    for s in srcs[1:]:
        acc = acc + s
    want_mean = acc * (F32(1) / F32(count))
    p0 = _arrays(seed=1)[0]
    lr = F32(0.05)
    want_p = p0 - (lr / F32(count)) * acc
    for lib in (port, ref):
        out = np.empty_like(p0)
        lib.psdt_mean(_ptrs(srcs), count, p0.size, _fp(out))
        np.testing.assert_array_equal(out, want_mean)
        p = p0.copy()
        lib.psdt_mean_sgd(_fp(p), _ptrs(srcs), count, p.size,
                          ctypes.c_float(lr))
        np.testing.assert_array_equal(p, want_p)


def test_sgd_momentum_adam_adamw(libs):
    port, ref = libs
    p0, g, m0, v0 = _arrays()
    v0 = np.abs(v0)
    lr, mu, b1, b2, eps, wd = (F32(x) for x in (0.01, 0.9, 0.9, 0.999,
                                                  1e-8, 1e-4))
    step = 3
    bc1, bc2 = F32(1 - 0.9 ** step), F32(1 - 0.999 ** step)
    one = F32(1)
    m_new = b1 * m0 + (one - b1) * g
    v_new = b2 * v0 + ((one - b2) * g) * g
    denom = np.sqrt(v_new / bc2) + eps
    want = {
        "sgd": (p0 - lr * g,),
        "momentum": (p0 - lr * (mu * m0 + g), mu * m0 + g),
        "adam": (p0 - (lr * (m_new / bc1)) / denom, m_new, v_new),
        "adamw": (p0 - lr * ((m_new / bc1) / denom + wd * p0), m_new, v_new),
    }
    for lib in (port, ref):
        got = {}
        p = p0.copy()
        lib.psdt_sgd(_fp(p), _fp(g), p.size, ctypes.c_float(lr))
        got["sgd"] = (p,)
        p, vel = p0.copy(), m0.copy()
        lib.psdt_momentum(_fp(p), _fp(g), _fp(vel), p.size,
                          ctypes.c_float(lr), ctypes.c_float(mu))
        got["momentum"] = (p, vel)
        for rule in ("adam", "adamw"):
            p, m, v = p0.copy(), m0.copy(), v0.copy()
            args = [_fp(p), _fp(g), _fp(m), _fp(v), p.size] + [
                ctypes.c_float(x) for x in (lr, b1, b2, eps, bc1, bc2)]
            if rule == "adam":
                lib.psdt_adam(*args)
            else:
                lib.psdt_adamw(*args, ctypes.c_float(wd))
            got[rule] = (p, m, v)
        for rule, arrays in want.items():
            for w, x in zip(arrays, got[rule]):
                np.testing.assert_array_equal(x, w, err_msg=rule)


def test_copy_and_codec_functions_match_the_reference_library(libs):
    port, ref = libs
    rng = np.random.default_rng(3)
    src = (rng.standard_normal(4099) * 5).astype(F32)
    src[::97] = src[5]                      # top-k threshold ties
    src[7], src[11] = np.inf, -np.inf
    src[13] = np.float32(1e-41)             # subnormal
    u8 = ctypes.POINTER(ctypes.c_uint8)
    outs = []
    for lib in (port, ref):
        got = {}
        buf = np.empty(src.nbytes, np.uint8)
        lib.psdt_copy(buf.ctypes.data, src.ctypes.data, src.nbytes)
        got["copy"] = buf.copy()
        for name, size, pack, unpack in (
                ("bf16", 2 * src.size, lib.psdt_pack_bf16,
                 lib.psdt_unpack_bf16),
                ("int8", 4 + src.size, lib.psdt_quant_int8,
                 lib.psdt_dequant_int8)):
            dst = np.zeros(size, np.uint8)
            pack(_fp(src), src.size, dst.ctypes.data_as(u8))
            back = np.empty(src.size, F32)
            unpack(dst.ctypes.data_as(u8), src.size, _fp(back))
            got[name] = (dst, back)
        k = 301
        dst = np.zeros(4 + 6 * k, np.uint8)
        lib.psdt_topk_pack(_fp(src), src.size, k, dst.ctypes.data_as(u8))
        back = np.empty(src.size, F32)
        assert lib.psdt_topk_unpack(dst.ctypes.data_as(u8), src.size,
                                    _fp(back)) == 0
        got["topk"] = (dst, back)
        outs.append(got)
    port_got, ref_got = outs
    np.testing.assert_array_equal(port_got["copy"], src.view(np.uint8))
    for name in ("bf16", "int8", "topk"):
        for a, b in zip(port_got[name], ref_got[name]):
            np.testing.assert_array_equal(a.view(np.uint8),
                                          b.view(np.uint8), err_msg=name)


def _host_rules(pkg):
    return {"sgd": lambda: pkg.SGD(0.05),
            "momentum": lambda: pkg.Momentum(0.05, 0.9),
            "adam": lambda: pkg.Adam(1e-2),
            "adamw": lambda: pkg.AdamW(1e-2, 1e-3),
            "lion": lambda: pkg.Lion(1e-3)}


@pytest.mark.parametrize("rule", ["sgd", "momentum", "adam", "adamw",
                                  "lion"])
@pytest.mark.parametrize("library", ["on", "off"])
def test_host_optimizers_take_the_references_path(libs, rule, library):
    """Three applies of each host rule, both libraries on or both off:
    the port's params and slots are the reference's bit for bit."""
    native.set_enabled(library == "on")
    ref_native.set_enabled(library == "on")
    rng = np.random.default_rng(5)
    # large enough that Adam's two paths (native, numpy) differ somewhere
    shapes = {"w": (70, 50), "b": (50,), "s": ()}
    params = {n: rng.standard_normal(s).astype(F32) for n, s in
              shapes.items()}
    port, ref = _host_rules(port_opt)[rule](), _host_rules(ref_opt)[rule]()
    p_port, p_ref = dict(params), dict(params)
    for _ in range(3):
        grads = {n: rng.standard_normal(s).astype(F32) for n, s in
                 shapes.items()}
        p_port = port.apply(p_port, grads)
        p_ref = ref.apply(p_ref, grads)
        for n in shapes:
            np.testing.assert_array_equal(np.asarray(p_port[n]),
                                          np.asarray(p_ref[n]), err_msg=n)
    state_port, state_ref = port.state_dict(), ref.state_dict()
    assert sorted(state_port) == sorted(state_ref)
    for key, slots in state_ref.items():
        if isinstance(slots, dict):
            for n, v in slots.items():
                np.testing.assert_array_equal(state_port[key][n], v)


@pytest.mark.parametrize("library", ["on", "off"])
def test_buffered_close_takes_the_fused_mean_sgd(libs, library):
    """Buffered aggregation with host SGD: with the libraries the close is
    the one-pass mean-SGD (another rounding than mean-then-SGD), without
    them numpy's mean and SGD; the port's core gives the reference core's
    bits either way."""
    native.set_enabled(library == "on")
    ref_native.set_enabled(library == "on")
    rng = np.random.default_rng(9)
    init = {"w": rng.standard_normal((6, 4)).astype(F32),
            "b": rng.standard_normal(4).astype(F32)}
    cores = [pkg.ParameterServerCore(total_workers=3,
                                     optimizer=opt.SGD(0.1),
                                     aggregation="buffered")
             for pkg, opt in ((ps_core, port_opt), (ref_core, ref_opt))]
    for core in cores:
        core.initialize_parameters(init)
    for it in range(2):
        for wid in range(3):
            grads = {n: rng.standard_normal(v.shape).astype(F32)
                     for n, v in init.items()}
            for core in cores:
                assert core.receive_gradients(wid, it, grads).success
    port_p, ref_p = (core.get_parameters() for core in cores)
    for n in init:
        np.testing.assert_array_equal(np.asarray(port_p[n]),
                                      np.asarray(ref_p[n]), err_msg=n)


def test_concurrent_builds_leave_one_loadable_library(tmp_path):
    """Two processes build into one empty directory at once: each gets a
    whole library at the same path, and no temporary file is left."""
    if subprocess.run(["which", "g++"], capture_output=True).returncode:
        pytest.skip("no g++")
    go = tmp_path / "go"
    script = textwrap.dedent(f"""
        import os, sys, time
        from parameter_server_distributed_tpu_torch import native
        native.BUILD_DIR = {str(tmp_path / "build")!r}
        while not os.path.exists({str(go)!r}):
            time.sleep(0.005)
        print(native._build())
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", script], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    try:
        go.touch()
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    paths = [out.strip().splitlines()[-1] for out, _ in outs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert paths[0] == paths[1] and paths[0].startswith(str(tmp_path))
    assert os.listdir(tmp_path / "build") == [os.path.basename(paths[0])]
    lib = native._bind(paths[0])
    out = np.zeros(3, F32)
    lib.psdt_sgd(_fp(out), _fp(np.ones(3, F32)), 3, ctypes.c_float(0.5))
    np.testing.assert_array_equal(out, [-0.5] * 3)


def test_refused_march_native_builds_plain_under_its_own_name(
        tmp_path, monkeypatch):
    """A g++ that refuses -march=native: the plain flags build under a
    name of their own, neither attempt leaves a temporary file, and the
    next build tries -march=native again before it takes the plain one."""
    calls = []

    def fake_g_plus_plus(cmd, **kwargs):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"partial")           # what a failed g++ leaves
        if "-march=native" in cmd:
            raise subprocess.CalledProcessError(1, cmd)
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.subprocess, "run", fake_g_plus_plus)
    path = native._build()
    assert path == native.library_path(()) != native.library_path()
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    assert ["-march=native" in cmd for cmd in calls] == [True, False]
    calls.clear()
    assert native._build() == path
    assert ["-march=native" in cmd for cmd in calls] == [True]
    assert os.listdir(tmp_path) == [os.path.basename(path)]


def test_psdt_native_0_resolves_numpy():
    script = textwrap.dedent("""
        from parameter_server_distributed_tpu_torch import native
        from parameter_server_distributed_tpu_torch.obs import stats
        from parameter_server_distributed_tpu_torch.rpc import codec
        assert not native.is_enabled() and native.lib() is None
        assert native.copy_fn() is None
        assert codec.active_codec().name == "python"
        assert stats.gauge("rpc.codec.native").value == 0.0
        print("numpy")
    """)
    env = dict(os.environ, PYTHONPATH=REPO, PSDT_NATIVE="0")
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "numpy" in proc.stdout, proc.stderr


def test_failed_build_is_retried(monkeypatch):
    calls = []
    monkeypatch.setattr(native, "_build", lambda: calls.append(1))
    native.reset_for_retry()
    try:
        native.set_enabled(True)
        assert native.lib() is None and native.lib() is None
        assert len(calls) == 1          # latched after one failure
        native.set_enabled(True)        # re-enabling clears the latch
        assert native.lib() is None and len(calls) == 2
    finally:
        monkeypatch.undo()
        native.reset_for_retry()
        native.set_enabled(_default())
