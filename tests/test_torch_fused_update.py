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


# The multi-tensor launch's planner (one launch over the whole store on the
# card; tests/test_torch_cuda.py runs the kernel itself).
CHUNK = fu.CHUNK
PLAN_SIZES = [
    [1, 3, 4099, 1 << 20, 0, CHUNK, CHUNK + 1, 0, 7],
    [3 * CHUNK + 5] * 300,                    # more tensors than a table
    [CHUNK * (fu.MAX_CHUNKS + 7) + 5, 17],    # one tensor past a table
]


def _chunks_of(rows, i):
    mine = rows[rows[:, 0] == i]
    return mine[np.argsort(mine[:, 1])]


@pytest.mark.parametrize("sizes", PLAN_SIZES)
def test_plan_covers_every_element_once(sizes):
    """Each tensor's chunks start at 0, abut, never overlap and end at its
    size; a zero-size tensor has none."""
    rows = np.concatenate(fu.plan(sizes, [True] * len(sizes)))
    assert set(rows[:, 0]) == {i for i, n in enumerate(sizes) if n}
    for i, n in enumerate(sizes):
        mine = _chunks_of(rows, i)
        if not n:
            assert len(mine) == 0
            continue
        starts, lengths = mine[:, 1], mine[:, 2]
        assert starts[0] == 0 and (lengths > 0).all()
        assert (lengths <= CHUNK).all() and (starts % CHUNK == 0).all()
        assert (starts[1:] == starts[:-1] + lengths[:-1]).all()
        assert starts[-1] + lengths[-1] == n


@pytest.mark.parametrize("sizes", PLAN_SIZES)
def test_plan_fits_the_kernel_table(sizes):
    """Every table fits the kernel's by-value parameter: at most
    MAX_CHUNKS chunks of at most MAX_TENSORS tensors, and the packed form
    (csrc/fused_update.cu Table) within CUDA's 32,764 bytes."""
    tables = fu.plan(sizes, [True] * len(sizes))
    for t in tables:
        assert 0 < len(t) <= fu.MAX_CHUNKS
        assert len(set(t[:, 0])) <= fu.MAX_TENSORS
    # Table: per tensor 5 operand pointers, a length, a first block and a
    # float4 flag; one byte a block; then Adam's 8 scalars
    table_bytes = fu.MAX_TENSORS * (8 * fu.OPERANDS + 8 + 4 + 1) \
        + fu.MAX_CHUNKS
    assert table_bytes == 29952 and table_bytes + 8 * 4 <= 32764
    total = sum(-(-n // CHUNK) for n in sizes)
    assert len(tables) >= -(-total // fu.MAX_CHUNKS)


def test_plan_float4_only_where_aligned():
    sizes = [4099, 1 << 20, 3, CHUNK * 2]
    aligned = [True, False, True, False]
    rows = np.concatenate(fu.plan(sizes, aligned))
    for i, ok in enumerate(aligned):
        assert set(rows[rows[:, 0] == i, 3]) == {int(ok)}


def test_llama_store_is_one_launch():
    """The llama_350m store (219 tensors, 336M elements) plans to one
    launch."""
    from parameter_server_distributed_tpu_torch.models.transformer import \
        llama_350m

    sizes = [int(np.prod(s)) for s in llama_350m().param_shapes().values()]
    assert len(sizes) == 219
    assert len(fu.plan(sizes, [True] * len(sizes))) == 1


@pytest.mark.parametrize("sizes", PLAN_SIZES)
def test_kernel_table_expands_to_the_plan(sizes):
    """The kernel's form of each table, read back as the kernel reads it
    (block b: tensor block[b], chunk b - first), is the planned table."""
    aligned = [i % 3 != 1 for i in range(len(sizes))]
    for table in fu.plan(sizes, aligned):
        tensors, n, first, vec, block = fu.kernel_table(table, sizes)
        assert len(tensors) <= fu.MAX_TENSORS and block.dtype == np.uint8
        b = np.arange(len(block))
        start = (b - first[block].astype(np.int64)) * CHUNK
        got = np.stack([tensors[block], start,
                        np.minimum(CHUNK, n[block] - start), vec[block]],
                       axis=1)
        np.testing.assert_array_equal(got, table)


def test_launch_args_take_float4_only_on_aligned_operands():
    """The host side of a launch on real tensors: a view 4 bytes into its
    storage (or one of its slots) takes the scalar path, zero-size
    tensors are left out, and each launch carries the operands' addresses
    in the kernel's (p, g, out, s0, s1) order."""
    def aligned(n):
        return torch.zeros(n + 4)[4:]

    def odd(n):
        return torch.zeros(n + 1)[1:]

    rows = [(aligned(4099), aligned(4099), aligned(4099), aligned(4099)),
            (odd(8), aligned(8), aligned(8), aligned(8)),
            (aligned(0), aligned(0), aligned(0), aligned(0)),
            (aligned(CHUNK + 3), aligned(CHUNK + 3), aligned(CHUNK + 3),
             odd(CHUNK + 3))]
    ops_in = np.zeros((len(rows), fu.OPERANDS), np.int64)
    ops_in[:, :4] = [[x.data_ptr() for x in r] for r in rows]
    sizes = tuple(r[0].numel() for r in rows)
    (ops, n, first, vec, block), = fu.launch_args(ops_in, sizes)
    np.testing.assert_array_equal(n, [4099, 8, CHUNK + 3])
    np.testing.assert_array_equal(vec, [1, 0, 0])
    np.testing.assert_array_equal(ops, ops_in[[0, 1, 3]])
    np.testing.assert_array_equal(block, [0, 1, 2, 2])
    np.testing.assert_array_equal(first, [0, 1, 2])


def test_no_gradient_passes_through_untouched():
    rng = np.random.default_rng(6)
    p, g = _torch(_store(rng)), _torch(_store(rng))
    del g["b"]
    for out in (fu.fused_sgd(p, g, 0.1),
                fu.fused_momentum(p, g, _torch(_store(rng)), 0.1)[0],
                fu.fused_adam(p, g, _torch(_store(rng)), _torch(_store(rng)),
                              1)[0]):
        assert out["b"] is p["b"]
        assert all(out[k] is not p[k] for k in g)
