"""The port's mixture-of-experts layer (models/moe.py) and the MoE
transformer rows against the JAX package, on the CPU.

- ``MoELayer`` against the JAX layer on one numpy store and input, top-1
  and top-2: the chosen experts and the kept assignments equal exactly
  (the reference's routing, taken here with its own JAX ops), the output
  and the aux loss within rtol 1e-5, atol 1e-6 (tests/test_moe.py:37-38);
  among the cases the forced collision that drops all but one token
  (tests/test_moe.py:41-55), drop-free decoding under collisions
  (:180-196) and a zero router whose probabilities tie.
- ``moe_lm`` and ``moe_lm_top2`` loss and gradients through both
  packages' Trainers: f32 within rtol 1e-4, atol 1e-6 (the loss within
  1e-5 relative); bf16 within 2^-5 of each tensor's largest entry.
- ``moe_350m`` has the reference's 207 tensors of 1,072,317,440
  parameters; the registry rows exist and refuse the stacked layout.
- A ``moe_lm`` DecodeServer streams the JAX server's greedy tokens, its
  prefill capacity-routed over the same padded bucket.
- The routed path makes no host sync, and ``quantize_params`` leaves the
  router and the expert banks alone.
- A mixed fleet (a port worker and a JAX worker on the port's PS) tracks
  a fleet of JAX workers on the JAX services within rtol 1e-4.

torch runs on one intra-op thread (bit-stable CPU gradients), and every
server and thread is stopped in teardown."""

import os
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from parameter_server_distributed_tpu import config as ref_config
from parameter_server_distributed_tpu import native
from parameter_server_distributed_tpu.models import moe as jm
from parameter_server_distributed_tpu.models import registry as ref_registry
from parameter_server_distributed_tpu.models import serving as jserving
from parameter_server_distributed_tpu.models import transformer as jt
from parameter_server_distributed_tpu.server.coordinator_service import \
    Coordinator as RefCoordinator
from parameter_server_distributed_tpu.server.ps_service import \
    ParameterServer as RefParameterServer
from parameter_server_distributed_tpu.worker.trainer import \
    Trainer as RefTrainer
from parameter_server_distributed_tpu.worker.worker import Worker as RefWorker
from parameter_server_distributed_tpu_torch import config as port_config
from parameter_server_distributed_tpu_torch import native as port_native
from parameter_server_distributed_tpu_torch.models import moe as tm
from parameter_server_distributed_tpu_torch.models import registry
from parameter_server_distributed_tpu_torch.models import serving
from parameter_server_distributed_tpu_torch.models import transformer as tt
from parameter_server_distributed_tpu_torch.models.convert import \
    params_from_numpy
from parameter_server_distributed_tpu_torch.models.quant import (
    QTensor, quantize_params)
from parameter_server_distributed_tpu_torch.server.coordinator_service \
    import Coordinator
from parameter_server_distributed_tpu_torch.server.ps_service import \
    ParameterServer
from parameter_server_distributed_tpu_torch.worker.trainer import Trainer
from parameter_server_distributed_tpu_torch.worker.worker import Worker

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
JOIN_S = 120.0


@pytest.fixture(autouse=True)
def hygiene():
    """One torch intra-op thread and both packages' numpy host paths,
    restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    native.set_enabled(False)
    port_native.set_enabled(False)
    try:
        yield
    finally:
        default = os.environ.get("PSDT_NATIVE", "1").lower() not in (
            "0", "false")
        native.set_enabled(default)
        port_native.set_enabled(default)
        torch.set_num_threads(threads)


def layer_pair(k, experts=4, d=16, ff=32, factor=1.25):
    ref = jm.MoELayer(jm.MoEConfig(d_model=d, d_ff=ff, num_experts=experts,
                                   top_k=k, capacity_factor=factor))
    port = tm.MoELayer(tm.MoEConfig(d_model=d, d_ff=ff, num_experts=experts,
                                    top_k=k, capacity_factor=factor))
    store = {n: np.array(v, np.float32) for n, v in ref.init_params(0).items()}
    return ref, port, store


def _routing(router_w, x, k, cap):
    """The reference's routing (models/moe.py:111-132) with its own ops:
    (top_idx [N, k], keep [N * k]) as JAX arrays."""
    tokens = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
    probs = jax.nn.softmax(jnp.dot(tokens, router_w.astype(jnp.float32)),
                           axis=-1)
    _, top_idx = jax.lax.top_k(probs, k)
    a_idx = top_idx.reshape(-1)
    onehot = jax.nn.one_hot(a_idx, probs.shape[-1], dtype=jnp.int32)
    pos = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=-1) - 1
    return top_idx, pos < cap


def jax_routing(store, x, k, cap):
    top_idx, keep = _routing(jnp.asarray(store["moe/router/w"]),
                             jnp.asarray(x), k, cap)
    return np.asarray(top_idx), np.asarray(keep)


def check_layer(ref, port, store, x, capacity_override=None):
    """Routes and keeps exact, output and aux within OUT_TOL; returns the
    port's keep mask."""
    n = x.shape[0] * x.shape[1]
    k = port.config.top_k
    cap = (capacity_override if capacity_override is not None
           else port.capacity(n * k))
    want_out, want_aux = ref.apply({n_: jnp.asarray(v)
                                    for n_, v in store.items()},
                                   jnp.asarray(x),
                                   capacity_override=capacity_override)
    params = {n_: torch.from_numpy(v) for n_, v in store.items()}
    out, aux = port.apply(params, torch.from_numpy(x),
                          capacity_override=capacity_override)
    routing = port.route(params["moe/router/w"],
                         torch.from_numpy(x).reshape(n, -1), cap)
    want_idx, want_keep = jax_routing(store, x, k, cap)
    np.testing.assert_array_equal(routing.top_idx.numpy(), want_idx)
    np.testing.assert_array_equal(routing.keep.numpy(), want_keep)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **OUT_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **OUT_TOL)
    return routing.keep.numpy()


# one token shape for every layer case: the reference's eager ops compile
# once a shape
SHAPE = (2, 24, 16)


def tokens(seed):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(
        np.float32)


@pytest.mark.parametrize("k", [1, 2])
def test_layer_matches_jax(k):
    # capacity factor 1: an expert chosen more than its share drops
    ref, port, store = layer_pair(k, factor=1.0)
    store["moe/router/w"] *= 25.0
    keep = check_layer(ref, port, store, tokens(k))
    assert 0 < keep.sum() < keep.size


@pytest.mark.parametrize("k", [1, 2])
def test_forced_collision_drops_all_but_capacity(k):
    """Every token routed to expert 0 (and with top-2 to expert 1, the
    lowest of the tied rest) at capacity k: the first k tokens fill each
    chosen expert's queue, the rest pass through as 0."""
    ref, port, store = layer_pair(k, factor=1 / 12)
    router = np.zeros((16, 4), np.float32)
    router[:, 0] = 10.0
    store["moe/router/w"] = router
    x = np.ones(SHAPE, np.float32)
    assert port.capacity(48 * k) == k
    keep = check_layer(ref, port, store, x)
    assert keep.sum() == k * k
    out, _ = port.apply({n: torch.from_numpy(v) for n, v in store.items()},
                        torch.from_numpy(x))
    assert int((out.abs().sum(-1) > 1e-9).sum()) == k


@pytest.mark.parametrize("k", [1, 2])
def test_decode_is_drop_free_under_collisions(k):
    """Identical rows route alike: at capacity factor 1 most drop, with
    the capacity at the token count (decoding) none does."""
    ref, port, store = layer_pair(k, factor=1.0)
    x = np.broadcast_to(tokens(3)[:1, :1], SHAPE).copy()
    dropped = check_layer(ref, port, store, x)
    kept = check_layer(ref, port, store, x, capacity_override=48)
    assert not dropped.all() and kept.all()
    out, _ = port.apply({n: torch.from_numpy(v) for n, v in store.items()},
                        torch.from_numpy(x), capacity_override=48)
    np.testing.assert_allclose(out[0, 0].numpy(), out[1, 23].numpy(),
                               rtol=1e-6)
    assert float(out.abs().sum()) > 0


@pytest.mark.parametrize("k", [1, 2])
def test_zero_router_ties_go_to_lower_experts(k):
    ref, port, store = layer_pair(k)
    store["moe/router/w"] = np.zeros_like(store["moe/router/w"])
    x = tokens(5)
    check_layer(ref, port, store, x, capacity_override=48)
    routing = port.route(torch.zeros(16, 4), torch.from_numpy(x[0]), 24)
    assert (routing.top_idx == torch.arange(k)).all()


def test_expert_slice_names_its_item():
    _, port, store = layer_pair(1)
    with pytest.raises(NotImplementedError, match="item 8"):
        port.apply({n: torch.from_numpy(v) for n, v in store.items()},
                   torch.zeros(1, 2, 16), expert_slice=(0, 2))


class _Syncs(TorchDispatchMode):
    """Counts the ops whose result the host must wait for: a data-sized
    output (nonzero, unique, masked_select) or a Python scalar."""
    SYNC = {"nonzero", "_local_scalar_dense", "equal", "is_nonzero",
            "unique", "_unique2", "masked_select", "item"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in self.SYNC:
            self.seen.append(func.__name__)
        return func(*args, **(kwargs or {}))


def test_routed_path_makes_no_host_sync(monkeypatch):
    """The routed path (the training forward and backward, and a decode
    round's drop-free FFN) asks for no data-sized or scalar result."""
    monkeypatch.setattr(torch.Tensor, "tolist", _refuse)
    monkeypatch.setattr(torch.Tensor, "item", _refuse)
    model = tt.moe_lm(seq=32, top_k=2)
    params = {n: v.requires_grad_() for n, v in
              model.init_params(0, device="cpu").items()}
    batch = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1024, (2, 32), dtype=np.int32))
    with _Syncs() as syncs:
        model.loss(params, batch).backward()
        with torch.no_grad():
            h = torch.randn(8, 1, 128)
            model.ffn_residual(params, 1, h, decode=True)
    assert syncs.seen == []


def _refuse(*args, **kwargs):
    raise AssertionError("a host sync on the routed path")


def test_factories_and_registry_rows_match_jax():
    for name in ("moe_lm", "switch_lm", "moe_350m"):
        ours, ref = getattr(tt, name)(), getattr(jt, name)()
        assert list(ours.param_shapes()) == list(ref.param_shapes()), name
        assert ours.param_shapes() == ref.param_shapes(), name
        assert ours.config.loss_chunk == ref.config.loss_chunk
    big = tt.moe_350m()
    assert len(big.param_shapes()) == 207
    assert big.num_params() == 1_072_317_440 == jt.moe_350m().num_params()
    for name in ("moe_lm", "moe_lm_top2", "switch_lm", "moe_350m"):
        ours = registry.get_model(name)
        ref, _ = ref_registry.get_model_and_batches(name, 1)
        assert ours.config.moe_top_k == ref.config.moe_top_k, name
        assert ours.param_shapes() == ref.param_shapes(), name
        # an MoE LM takes no stacked layout: asked for, it raises; turned
        # off, it is a no-op (as the reference's registry)
        with pytest.raises(ValueError, match="scan_layers"):
            registry.get_model(name, scan=True)
        assert registry.get_model(name, scan=False).config.moe_every > 0
    with pytest.raises(ValueError, match="homogeneous"):
        tt.Transformer(tt.TransformerConfig(moe_every=2, scan_layers=True))


def test_init_scales_the_expert_banks_as_jax():
    """Fan-in of a 3-D bank is its middle dim, ``moe/w2`` takes the depth
    scale, the router 1/sqrt(d): the port's init has the reference's
    scale per tensor (a different random stream)."""
    model = tt.Transformer(tt.TransformerConfig(
        vocab=64, d_model=256, n_heads=4, n_layers=24, d_ff=512,
        moe_every=2))
    params = model.init_params(0, device="cpu")
    c = model.config
    want = {"layer1/moe/router/w": 1 / np.sqrt(c.d_model),
            "layer1/moe/w1": 1 / np.sqrt(c.d_model),
            "layer1/moe/w2": 1 / np.sqrt(c.d_ff) / np.sqrt(2 * c.n_layers)}
    for name, std in want.items():
        got = float(params[name].float().std())
        assert abs(got - std) < 0.05 * std, (name, got, std)


def moe_models(top_k, dtype_j=jnp.float32, dtype_t=torch.float32):
    return (jt.moe_lm(seq=32, top_k=top_k, dtype=dtype_j),
            tt.moe_lm(seq=32, top_k=top_k, dtype=dtype_t))


def moe_store(model, seed=0):
    return {n: np.array(v, np.float32)
            for n, v in model.init_params(seed).items()}


@pytest.mark.parametrize("top_k", [1, 2], ids=["moe_lm", "moe_lm_top2"])
def test_loss_and_gradients_match_jax_f32(top_k):
    jmodel, pmodel = moe_models(top_k)
    store = moe_store(jmodel, top_k)
    batch = np.random.default_rng(top_k).integers(0, 1024, (2, 32),
                                                  dtype=np.int32)
    ref_g, ref_loss = RefTrainer(
        jmodel, local_devices=jax.devices()[:1]).compute_gradients(
            store, batch)
    grads, loss = Trainer(pmodel, device="cpu").compute_gradients(store,
                                                                  batch)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    assert sorted(grads) == sorted(ref_g)
    for name, ref in ref_g.items():
        np.testing.assert_allclose(grads[name], np.asarray(ref), **GRAD_TOL,
                                   err_msg=name)
    assert np.abs(grads["layer1/moe/router/w"]).max() > 0


def jax_bf16_routes(jmodel, params, tokens):
    """The JAX model's routing at each MoE layer of its bf16 forward
    (compiled without excess precision, as the gradients are):
    [(top_idx, keep)]."""
    c = jmodel.config
    b, s = tokens.shape
    cap = jmodel._moe.capacity(b * s * c.moe_top_k)

    def routes(params, tokens):
        positions = jnp.arange(s, dtype=jnp.int32)[None].repeat(b, 0)
        h = jmodel.embed(params, tokens, positions)
        out = []
        for i in range(c.n_layers):
            p = f"layer{i}"
            q, k, v = jmodel.qkv(params, p, h, positions)
            h = jmodel.attn_residual(params, p, h,
                                     jmodel.attention_fn(q, k, v))
            if c.is_moe_layer(i):
                out.append(_routing(params[f"{p}/moe/router/w"],
                                    jmodel._norm(params, f"{p}/ln2", h),
                                    c.moe_top_k, cap))
            h, _ = jmodel.ffn_residual(params, i, h)
        return out

    run = jax.jit(routes).lower(params, tokens).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return [(np.asarray(i), np.asarray(k)) for i, k in run(params, tokens)]


@pytest.mark.parametrize("top_k", [1, 2], ids=["moe_lm", "moe_lm_top2"])
def test_bf16_gradients_within_rounding(top_k):
    """bf16: both packages route every assignment alike (checked first:
    routing is a discontinuous function of bf16 activations the two
    frameworks round at different places, so a near tie may go either
    way, as it does between two XLA compilations of the reference), then
    the loss within 1e-2 relative and the gradients within 2^-5 of each
    tensor's largest entry.  The reference is compiled with
    ``xla_allow_excess_precision`` off, so it rounds at every bf16 cast
    as the port does (tests/test_torch_resnet.py)."""
    jmodel, pmodel = moe_models(top_k, jnp.bfloat16, torch.bfloat16)
    store = moe_store(jt.moe_lm(seq=32, top_k=top_k), 8)
    batch = np.random.default_rng(9).integers(0, 1024, (2, 32),
                                              dtype=np.int32)
    params = {n: jnp.asarray(v, jnp.bfloat16) for n, v in store.items()}
    step = jax.jit(jax.value_and_grad(jmodel.loss)).lower(
        params, batch).compile(
        compiler_options={"xla_allow_excess_precision": False})
    ref_loss, ref_g = step(params, batch)
    routes, route = [], pmodel._moe.route

    def observed(*args):
        routing = route(*args)
        routes.append((routing.top_idx.numpy().copy(),
                       routing.keep.numpy().copy()))
        return routing

    pmodel._moe.route = observed
    grads, loss = Trainer(pmodel, device="cpu").compute_gradients(store,
                                                                  batch)
    for (idx, keep), (want_idx, want_keep) in zip(
            routes, jax_bf16_routes(jmodel, params, jnp.asarray(batch)),
            strict=True):
        np.testing.assert_array_equal(idx, want_idx)
        np.testing.assert_array_equal(keep, want_keep)
    assert abs(loss - float(ref_loss)) <= 1e-2 * abs(float(ref_loss))
    for name, ref in ref_g.items():
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(grads[name], ref, rtol=0,
                                   atol=2.0 ** -5 * np.abs(ref).max(),
                                   err_msg=name)


def test_bf16_store_converts_bit_exact():
    store = {n: v.astype(ml_dtypes.bfloat16)
             for n, v in moe_store(jt.moe_lm(seq=32)).items()}
    params = params_from_numpy(store, tt.moe_lm(
        seq=32, dtype=torch.bfloat16).config, device="cpu")
    for name, arr in store.items():
        assert params[name].dtype == torch.bfloat16
        assert params[name].view(torch.uint16).numpy().tobytes() == \
            arr.view(np.uint16).tobytes(), name


def test_quantize_leaves_the_expert_banks_alone():
    model = tt.moe_lm(seq=32)
    params = model.init_params(0, device="cpu")
    q = quantize_params(params)
    for name, value in q.items():
        if "/moe/" in name:
            assert value is params[name], name
    assert isinstance(q["layer0/mlp/w1"], QTensor)
    assert isinstance(q["lm_head/w"], QTensor)
    # a quantized MoE store still serves
    srv = serving.DecodeServer(model, q, slots=1, max_len=32, device="cpu")
    rid = srv.submit([1, 2, 3], max_new_tokens=3)
    assert len(srv.run_to_completion()[rid]) == 3


def test_server_streams_the_jax_servers_tokens():
    """Greedy streams token-exact against the JAX DecodeServer; the
    prompts' prefill runs capacity-routed over the padded bucket (some
    assignments drop there), decode drop-free, on both sides."""
    jmodel, pmodel = moe_models(1)
    store = moe_store(jmodel, 11)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 1024, n).tolist() for n in (30, 29)]
    ref = jserving.DecodeServer(
        jmodel, {n: jnp.asarray(v) for n, v in store.items()}, slots=2,
        max_len=64)
    ref_ids = [ref.submit(p, max_new_tokens=6) for p in prompts]
    ref_out = ref.run_to_completion()
    srv = serving.DecodeServer(pmodel, params_from_numpy(
        store, pmodel.config, device="cpu"), slots=2, max_len=64,
        device="cpu")
    keeps, route = [], pmodel._moe.route

    def observed(*args):
        routing = route(*args)
        keeps.append((routing.keep.clone(), routing.capacity))
        return routing

    pmodel._moe.route = observed
    rids = [srv.submit(p, max_new_tokens=6) for p in prompts]
    got = srv.run_to_completion()
    assert [got[r] for r in rids] == [ref_out[r] for r in ref_ids]
    # two prefills through two MoE layers route the 32-token bucket at
    # capacity 10, and drop some of the prompt's own tokens there; the
    # decode rounds route their 2 tokens drop-free
    prefill = [(keep, cap) for keep, cap in keeps if keep.numel() == 32]
    assert len(prefill) == 4 and {cap for _, cap in prefill} == {10}
    assert any(not keep[:29].all() for keep, _ in prefill)
    rounds = [keep for keep, _ in keeps if keep.numel() == 2]
    assert len(rounds) == 2 * 5 and all(keep.all() for keep in rounds)


# ---- the mixed fleet ---------------------------------------------------

MODEL, BATCH, LR = "moe_lm", 2, 0.5


@pytest.fixture
def servers():
    started = []

    def start(port_side: bool, tmp):
        cfg = port_config if port_side else ref_config
        ps_kw = dict(bind_address="127.0.0.1", port=0, total_workers=2,
                     checkpoint_dir=str(tmp), optimizer="sgd",
                     learning_rate=LR)
        if port_side:
            ps_kw["device"] = "cpu"
        else:
            ps_kw["autosave_period_s"] = 600.0
        ps = (ParameterServer if port_side else RefParameterServer)(
            cfg.ParameterServerConfig(**ps_kw))
        started.append(ps)
        ps_port = ps.start()
        coordinator = (Coordinator if port_side else RefCoordinator)(
            cfg.CoordinatorConfig(bind_address="127.0.0.1", port=0,
                                  ps_address="127.0.0.1", ps_port=ps_port,
                                  reap_period_s=600.0))
        started.append(coordinator)
        return ps, coordinator.start()

    yield start
    for server in reversed(started):
        server.stop()


_REF_TRAINERS: dict = {}


def ref_worker(coord_port, wid):
    if wid not in _REF_TRAINERS:
        _REF_TRAINERS[wid] = RefTrainer(
            ref_registry.get_model_and_batches(MODEL, BATCH)[0],
            local_devices=jax.devices()[:1])
    _, batches = ref_registry.get_model_and_batches(MODEL, BATCH, seed=wid)
    return RefWorker(ref_config.WorkerConfig(
        coordinator_address=f"127.0.0.1:{coord_port}", worker_id=wid,
        batch_size=BATCH, model=MODEL, heartbeat_period_s=1.0),
        _REF_TRAINERS[wid], batches)


def port_worker(coord_port, wid):
    model, batches = registry.get_model_and_batches(MODEL, BATCH, seed=wid,
                                                    device="cpu")
    return Worker(port_config.WorkerConfig(
        coordinator_address=f"127.0.0.1:{coord_port}", worker_id=wid,
        batch_size=BATCH, model=MODEL, heartbeat_period_s=1.0,
        device="cpu"), Trainer(model, device="cpu"), batches)


def run_fleet(start, port_side, makers, init, tmp, rounds=2):
    ps, coord_port = start(port_side, tmp)
    ps.core.initialize_parameters(init)
    workers = [make(coord_port, wid) for wid, make in enumerate(makers)]
    losses = {wid: [] for wid in range(len(workers))}
    errors = []

    def loop(wid, worker):
        try:
            for it in range(rounds):
                losses[wid].append(worker.run_iteration(it))
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append((wid, exc))

    try:
        for w in workers:
            w.initialize()
        threads = [threading.Thread(target=loop, args=(wid, w), daemon=True)
                   for wid, w in enumerate(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
        assert not any(t.is_alive() for t in threads), "a worker hung"
    finally:
        for w in workers:
            w.shutdown()
    assert not errors, f"worker failures: {errors}"
    store = {k: np.array(v.numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in ps.core.get_parameters().items()}
    return losses, store


def test_mixed_moe_fleet_tracks_jax_fleet(servers, tmp_path, monkeypatch):
    monkeypatch.setenv("PSDT_SHM", "1")
    init = moe_store(ref_registry.get_model_and_batches(MODEL, BATCH)[0])
    base_losses, base_store = run_fleet(servers, False,
                                        [ref_worker, ref_worker], init,
                                        tmp_path / "jax")
    losses, store = run_fleet(servers, True, [port_worker, ref_worker],
                              init, tmp_path / "mixed")
    for wid in (0, 1):
        assert len(losses[wid]) == 2
        np.testing.assert_allclose(losses[wid], base_losses[wid], rtol=1e-4,
                                   err_msg=f"worker {wid}")
    assert sorted(store) == sorted(base_store)
    for name in base_store:
        np.testing.assert_allclose(store[name], base_store[name], rtol=5e-4,
                                   atol=1e-5, err_msg=name)
    assert not np.array_equal(store["layer1/moe/w1"], init["layer1/moe/w1"])
