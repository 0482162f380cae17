"""Fused optimizer updates and PallasOptimizer of the PyTorch port
(ops/fused_update.py, async_sgd/device_optimizer.py) against the JAX
package (Pallas in interpret mode, as tests/test_pallas_ops.py runs it).
On the CPU the port takes its plain versions (tests/test_torch_cuda.py
holds the Hopper kernels against them on the card).

Tolerances are the reference's own (tests/test_pallas_ops.py): the fused
functions rtol 1e-5, atol 1e-7 (:50-88); the optimizer over several
applies rtol 1e-4 (:124-152); a reloaded optimizer's next apply rtol
1e-5, atol 1e-7 (:155-172)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu.async_sgd import \
    device_optimizer as jax_opt
from parameter_server_distributed_tpu.ops.pallas import \
    fused_update as jax_fu
from parameter_server_distributed_tpu_torch.async_sgd.device_optimizer \
    import PallasOptimizer
from parameter_server_distributed_tpu_torch.ops import fused_update as fu

TOL = dict(rtol=1e-5, atol=1e-7)
SHAPES = {"w": (13, 7), "b": (5,), "e": (3, 4, 6)}


def _store(rng, scale=1.0):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _torch(store):
    return {k: torch.from_numpy(v.copy()) for k, v in store.items()}


def _jax(store):
    return {k: jnp.asarray(v) for k, v in store.items()}


def _close(got, ref, **tol):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                   **(tol or TOL), err_msg=k)


def test_fused_sgd_matches_pallas():
    rng = np.random.default_rng(0)
    p, g = _store(rng), _store(rng)
    g.pop("b")   # a param with no gradient passes through
    _close(fu.fused_sgd(_torch(p), _torch(g), lr=0.3),
           jax_fu.fused_sgd(_jax(p), _jax(g), lr=0.3, interpret=True))


def test_fused_momentum_matches_pallas():
    rng = np.random.default_rng(1)
    p, g, vel = _store(rng), _store(rng), _store(rng)
    tvel = _torch(vel)
    new_p, new_v = fu.fused_momentum(_torch(p), _torch(g), tvel, lr=0.1,
                                     mu=0.9)
    ref_p, ref_v = jax_fu.fused_momentum(_jax(p), _jax(g), _jax(vel), lr=0.1,
                                         mu=0.9, interpret=True)
    _close(new_p, ref_p)
    _close(new_v, ref_v)
    assert all(new_v[k] is tvel[k] for k in tvel)   # updated in place


@pytest.mark.parametrize("step", [1, 7])
def test_fused_adam_matches_pallas(step):
    rng = np.random.default_rng(step)
    p, g = _store(rng), _store(rng)
    m, v = _store(rng, 0.1), {k: np.abs(x) for k, x in _store(rng, 0.1).items()}
    tm, tv = _torch(m), _torch(v)
    new_p, new_m, new_v = fu.fused_adam(_torch(p), _torch(g), tm, tv, step,
                                        lr=0.01)
    ref = jax_fu.fused_adam(_jax(p), _jax(g), _jax(m), _jax(v), step,
                            lr=0.01, interpret=True)
    for got, r in zip((new_p, new_m, new_v), ref):
        _close(got, r)
    assert all(new_m[k] is tm[k] and new_v[k] is tv[k] for k in tm)


def test_bias_corrections_in_f32():
    bc1, bc2 = fu.bias_corrections(3, 0.9, 0.999)
    assert bc1 == float(np.float32(1) - np.float32(0.9) ** np.float32(3))
    assert bc2 == float(np.float32(1) - np.float32(0.999) ** np.float32(3))


@pytest.mark.parametrize("rule", ["sgd", "momentum", "adam"])
def test_pallas_optimizer_matches_jax(rule):
    rng = np.random.default_rng(3)
    init = _store(rng)
    grad_seq = [_store(rng) for _ in range(3)]
    port = PallasOptimizer(rule, 0.1, device="cpu")
    ref = jax_opt.PallasOptimizer(rule, 0.1)
    p_port, p_ref = dict(init), dict(init)
    for g in grad_seq:
        p_port = port.apply(p_port, g)
        p_ref = ref.apply(p_ref, g)
        assert all(isinstance(x, torch.Tensor) for x in p_port.values())
    _close(p_port, p_ref, rtol=1e-4, atol=1e-6)
    assert port.step == ref.step == 3
    state, ref_state = port.state_dict(), ref.state_dict()
    assert sorted(state) == sorted(ref_state)
    _close(state, ref_state, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_dict_round_trips(direction):
    """A checkpoint of one package's optimizer loads into the other's, and
    the next apply agrees."""
    rng = np.random.default_rng(4)
    p, g = _store(rng), _store(rng)
    port = PallasOptimizer("adam", 0.01, device="cpu")
    ref = jax_opt.PallasOptimizer("adam", 0.01)
    src, dst = (ref, port) if direction == "jax_to_port" else (port, ref)
    p2 = {k: np.asarray(x) for k, x in src.apply(p, g).items()}
    src.apply(p2, g)
    dst.load_state_dict(src.state_dict())
    assert dst.step == src.step == 2
    _close(dst.apply(p2, g), src.apply(p2, g))


def test_optimizer_refuses_unknown_rule():
    with pytest.raises(ValueError, match="unknown pallas rule"):
        PallasOptimizer("lion", device="cpu")


def test_cpu_updates_count_no_launch():
    fu.reset_launches()
    PallasOptimizer("adam", device="cpu").apply(
        {"w": np.ones(3, np.float32)}, {"w": np.ones(3, np.float32)})
    assert sum(fu.launches.values()) == 0
