"""The port's delta subsystem (delta/, the core's delta sink, the PS
service's delta serve) against the JAX package's, in process on the CPU.

- The delta messages encode byte for byte as the JAX package's, both
  ways, and the extra PS methods are the same.
- Over one numpy store sequence, per name and as flat-arena slabs
  (slab buffers refilled in place, as the flat close's pinned readback
  buffers are), the port's ``DeltaChain`` builds the JAX chain's pairs:
  the same entries (indices, value bytes, dense or sparse), store crcs,
  changed counts and servable chains, at every wire dtype, stripe count
  and chain depth (past the budget, and 0).  The sequence carries 0.0 ->
  -0.0 flips and NaNs; both packages run their numpy codecs, or both
  their C++ ones (which keep a NaN's payload where numpy quiets it).
- Through the port's service: chain-applied deltas bit for bit a full
  pull at every dtype, chunk budget and stripe count; a receiver past
  the depth, of another encoding, or behind a restore served in full,
  and no served version reused after a restore, as the JAX service
  does; malformed entries take the base-mismatch path.
- The flat close (``PSDT_ARENA=1``, the sharded optimizer on the CPU)
  feeding the chain over two closes; an async core notifying at every
  apply (port-only).

Every tolerance is byte equality.  Both packages' C++ host libraries are
switched off unless a case pairs them, and torch runs one intra-op
thread."""

import os

import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu import native as ref_native
from parameter_server_distributed_tpu.checkpoint.manager import \
    CheckpointManager as RefCheckpointManager
from parameter_server_distributed_tpu.core import arena as ref_arena
from parameter_server_distributed_tpu.core.optimizer import SGD as RefSGD
from parameter_server_distributed_tpu.core.ps_core import \
    ParameterServerCore as RefCore
from parameter_server_distributed_tpu.delta import chain as ref_chain
from parameter_server_distributed_tpu.delta import client as ref_client
from parameter_server_distributed_tpu.delta import messages as ref_dmsg
from parameter_server_distributed_tpu.rpc import messages as ref_m
from parameter_server_distributed_tpu.server.ps_service import \
    ParameterServerService as RefService
from parameter_server_distributed_tpu_torch import native
from parameter_server_distributed_tpu_torch.async_sgd.device_optimizer \
    import ShardedDeviceOptimizer
from parameter_server_distributed_tpu_torch.checkpoint.manager import \
    CheckpointManager
from parameter_server_distributed_tpu_torch.core import arena
from parameter_server_distributed_tpu_torch.core.optimizer import SGD
from parameter_server_distributed_tpu_torch.core.ps_core import \
    ParameterServerCore
from parameter_server_distributed_tpu_torch.core.tensor import (to_host,
                                                                to_wire)
from parameter_server_distributed_tpu_torch.delta import chain as tchain
from parameter_server_distributed_tpu_torch.delta import messages as dmsg
from parameter_server_distributed_tpu_torch.delta.client import (
    DeltaBaseMismatch, DeltaPullState, apply_frames)
from parameter_server_distributed_tpu_torch.obs import stats as obs_stats
from parameter_server_distributed_tpu_torch.rpc import messages as m
from parameter_server_distributed_tpu_torch.rpc.data_plane import \
    decode_gradients
from parameter_server_distributed_tpu_torch.server.ps_service import \
    ParameterServerService

SHAPES = {"emb/w": (33, 17), "l0/w": (24, 40), "l0/b": (40,),
          "odd": (257,), "head/w": (17, 9)}
DTYPES = {"bf16": m.WIRE_BF16, "f32": m.WIRE_F32, "raw": m.WIRE_RAW_F32}


@pytest.fixture(autouse=True)
def hygiene():
    """Both packages' numpy codecs and host paths, one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    native.set_enabled(False)
    ref_native.set_enabled(False)
    try:
        yield
    finally:
        default = os.environ.get("PSDT_NATIVE", "1").lower() not in (
            "0", "false")
        native.set_enabled(default)
        ref_native.set_enabled(default)
        torch.set_num_threads(threads)


# ------------------------------------------------------------- messages
def _messages(dm, mm):
    entries = [dm.DeltaEntry(name="l0/w", indices=b"\x01\x00\x00\x00",
                             values=b"\x80\x3f"),
               dm.DeltaEntry(name="odd", values=b"\x00\x00\x80\x3f" * 3,
                             dense=True)]
    return {
        "DeltaEntry": entries[0],
        "DeltaFrame/delta": dm.DeltaFrame(
            from_version=7, to_version=8, delta=True, entries=entries,
            crc=(1 << 32) - 5, last=True, wire_dtype=mm.WIRE_BF16),
        "DeltaFrame/full": dm.DeltaFrame(
            push=mm.PushResponse(success=True, message="ok", iteration=3,
                                 aggregation_complete=True,
                                 workers_received=2, total_workers=2),
            params=mm.ParameterUpdate(iteration=3, ready=True, parameters=[
                mm.Tensor.from_array("w", np.arange(4, dtype=np.float32),
                                     wire_dtype=mm.WIRE_BF16)]),
            to_version=1 << 40, last=True),
        "DeltaPullRequest": dm.DeltaPullRequest(
            worker_id=3, iteration=9, wire_dtype=mm.WIRE_BF16,
            held_version=12, trace_context=b"\x07"),
        "DeltaPushChunk": dm.DeltaPushChunk(
            update=mm.GradientUpdate(
                worker_id=1, iteration=4, pull_wire_dtype=mm.WIRE_BF16,
                gradients=[mm.Tensor.from_array(
                    "g", np.ones(3, np.float32), wire_dtype=mm.WIRE_RAW_F32)]),
            held_version=5),
        "SubscribeRequest": dm.SubscribeRequest(
            subscriber_id=77, held_version=0, wire_dtype=mm.WIRE_BF16),
    }


@pytest.mark.parametrize("kind", sorted(_messages(dmsg, m)))
def test_delta_messages_byte_equal_jax_both_ways(kind):
    port, ref = _messages(dmsg, m)[kind], _messages(ref_dmsg, ref_m)[kind]
    data = port.encode()
    assert data == ref.encode()
    cls = type(port)
    assert cls.decode(ref.encode()).encode() == data
    assert type(ref).decode(data).encode() == data


def test_delta_methods_and_knobs_match_jax(monkeypatch):
    def table(methods):
        return {k: (v[0].__name__, v[1].__name__, v[2])
                for k, v in methods.items()}

    assert table(dmsg.DELTA_PS_METHODS) == table(ref_dmsg.DELTA_PS_METHODS)
    for depth in ("0", "4", "9"):
        monkeypatch.setenv("PSDT_DELTA_DEPTH", depth)
        assert dmsg.delta_depth() == ref_dmsg.delta_depth()
        assert dmsg.delta_enabled() == ref_dmsg.delta_enabled()
    for name in ("bf16", "f32", "raw"):
        monkeypatch.setenv("PSDT_DELTA_DTYPE", name)
        assert tchain.delta_wire_dtype() == ref_chain.delta_wire_dtype()
    monkeypatch.setenv("PSDT_DELTA_DTYPE", "int8")
    for mod in (tchain, ref_chain):
        with pytest.raises(ValueError, match="elementwise"):
            mod.delta_wire_dtype()
    for a in DTYPES.values():
        for b in DTYPES.values():
            assert (tchain.wire_dtype_compatible(a, b)
                    == ref_chain.wire_dtype_compatible(a, b))


# ---------------------------------------------------------- the chain
def _versions(seed: int, n: int = 6) -> list[dict]:
    """A store sequence: small steps (many below a bf16 ulp), a dense
    jump, 0.0 <-> -0.0 flips, NaNs (a signalling payload among them) and
    infinities."""
    rng = np.random.default_rng(seed)
    store = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in SHAPES.items()}
    store["odd"][:8] = 0.0
    out = [{k: v.copy() for k, v in store.items()}]
    for v in range(1, n):
        for name, arr in store.items():
            flat = arr.reshape(-1)
            if v == 3 and name == "l0/w":
                flat += np.float32(0.5)   # a dense version of one tensor
            else:
                hit = rng.random(flat.size) < 0.3
                with np.errstate(invalid="ignore"):   # the NaN slots
                    flat[hit] += (rng.standard_normal(int(hit.sum()))
                                  * 1e-3).astype(np.float32)
        store["odd"][:8] = (-store["odd"][:8]) if v % 2 else store["odd"][:8]
        bits = store["odd"].view(np.uint32)
        bits[9 + v] = 0x7FA00001 if v % 2 else 0xFFC00000
        store["odd"][30 + v] = np.inf if v % 2 else -np.inf
        out.append({k: a.copy() for k, a in store.items()})
    return out


class _Slabs:
    """Each package's flat-arena store over one set of slab buffers,
    refilled in place every version."""

    def __init__(self, mod, store, stripes):
        self.mod = mod
        self.table = mod.PackingTable(store, stripes, epoch=1)
        self.slabs = {s: np.zeros(self.table.stripe_sizes[s], np.float32)
                      for s in range(stripes)}

    def store(self, values):
        views = {}
        for s, slab in self.slabs.items():
            views.update(self.table.views(s, slab))
        for name, arr in values.items():
            views[name][...] = arr
        return self.mod.ArenaStore({n: views[n] for n in values},
                                   self.table, self.slabs)


def _pairs(chain, top: int) -> list:
    """Every servable chain held -> top, as plain tuples."""
    out = []
    for held in range(0, top + 1):
        pairs = chain.pairs_between(held, top)
        out.append(None if pairs is None else [
            (p.from_version, p.to_version, p.entries, p.nbytes, p.crc,
             p.changed, p.total) for p in pairs])
    return out


def _run_chains(versions, layout, wire_dtype, stripes, depth):
    port = tchain.DeltaChain(depth=depth, wire_dtype=wire_dtype,
                             stripes=stripes)
    ref = ref_chain.DeltaChain(depth=depth, wire_dtype=wire_dtype,
                               stripes=stripes)
    slabs = ({c: _Slabs(mod, versions[0], stripes)
              for c, mod in ((port, arena), (ref, ref_arena))}
             if layout == "arena" else None)
    for v, values in enumerate(versions, start=1):
        for c in (port, ref):
            store = (slabs[c].store(values) if slabs
                     else {k: a.copy() for k, a in values.items()})
            c.note_apply(store, v)
        assert port.version == ref.version == v
        assert _pairs(port, v) == _pairs(ref, v), v
    return port, ref


@pytest.mark.parametrize("stripes", [1, 3])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", ["per_name", "arena"])
def test_chain_matches_jax_chain(layout, dtype, stripes):
    versions = _versions(stripes)
    port, _ = _run_chains(versions, layout, DTYPES[dtype], stripes, depth=8)
    # every hop built, the dense tensor dense, the others sparse
    pairs = port.pairs_between(1, len(versions))
    assert [p.to_version for p in pairs] == list(range(2, len(versions) + 1))
    dense = {e[0]: e[3] for e in pairs[2].entries}   # the pair 3 -> 4
    assert dense["l0/w"] and not dense["emb/w"]
    # the crc of the last pair is the store crc of the decoded last store
    decoded = {k: m.Tensor.from_array(k, a, wire_dtype=DTYPES[dtype])
               .to_array() for k, a in versions[-1].items()}
    assert pairs[-1].crc == tchain.store_crc(decoded)


@pytest.mark.parametrize("depth", [0, 2])
def test_chain_depth_budget_matches_jax(depth):
    versions = _versions(9, n=5)
    port, _ = _run_chains(versions, "per_name", m.WIRE_BF16, 2, depth)
    servable = [h for h in range(1, 5) if port.pairs_between(h, 5)]
    assert servable == list(range(5 - depth, 5))


def test_chain_reset_matches_jax():
    versions = _versions(4, n=4)
    port, ref = _run_chains(versions, "per_name", m.WIRE_BF16, 1, 4)
    for c in (port, ref):
        c.reset()
        assert c.version == -1 and c.pairs_between(3, 4) is None
        # a gap: version 6 after a reset builds no pair
        c.note_apply({k: a.copy() for k, a in versions[0].items()}, 6)
        c.note_apply({k: a.copy() for k, a in versions[1].items()}, 7)
    assert _pairs(port, 7) == _pairs(ref, 7)
    assert port.pairs_between(6, 7) and not port.pairs_between(5, 7)


@pytest.mark.parametrize("codec", ["numpy", "native"])
def test_delta_bitwise_semantics_negzero_and_nan(codec):
    """The diff is bitwise in wire space: 0.0 -> -0.0 ships and a NaN
    patches to the bytes a full pull carries.  The numpy codecs round a
    bf16 NaN to the quiet NaN of its sign; the C++ ones keep its
    payload; each package's chain follows its codec, the same on both
    sides when the codecs pair."""
    if codec == "native":
        native.set_enabled(True)
        ref_native.set_enabled(True)
        if native.lib() is None or ref_native.lib() is None:
            pytest.skip("a C++ host library did not build here")
    w0 = np.zeros(8, np.float32)
    w1 = w0.copy()
    w1[1] = np.float32(-0.0)
    w1.view(np.uint32)[2] = 0x7FA00001   # a signalling NaN with a payload
    chains = [mod.DeltaChain(depth=4, wire_dtype=m.WIRE_BF16, stripes=1)
              for mod in (tchain, ref_chain)]
    for c in chains:
        c.note_apply({"w": w0.copy()}, 1)
        c.note_apply({"w": w1.copy()}, 2)
    (port_pair,), (ref_pair,) = (c.pairs_between(1, 2) for c in chains)
    assert port_pair.entries == ref_pair.entries
    name, idx, vals, dense = port_pair.entries[0]
    assert not dense
    assert np.frombuffer(idx, "<u4").tolist() == [1, 2]
    nan_bits = np.frombuffer(vals, "<u2")[1]
    # the C++ codecs keep the payload's top bits and set the quiet bit
    assert nan_bits == (0x7FE0 if codec == "native" else 0x7FC0)
    # applied to a receiver holding version 1: the full pull's bytes
    state = DeltaPullState()
    state.note_full({"w": w0.copy()}, 1)
    frames = [dmsg.DeltaFrame(
        from_version=1, to_version=2, delta=True, wire_dtype=m.WIRE_BF16,
        entries=[dmsg.DeltaEntry(name=name, indices=idx, values=vals)],
        crc=port_pair.crc, last=True)]
    result = apply_frames(iter(frames), state)
    full = m.Tensor.from_array("w", w1, wire_dtype=m.WIRE_BF16).to_array()
    assert result.served_delta
    assert result.store["w"].tobytes() == full.tobytes()
    assert np.signbit(result.store["w"][1])


@pytest.mark.parametrize("indices,values", [
    # out of range, though the last index is in range
    (np.array([12, 3], "<u4").tobytes(), np.zeros(2, "<u2").tobytes()),
    # a values buffer that is not whole elements
    (np.array([1], "<u4").tobytes(), b"\x00\x01\x02"),
    # an index buffer that is not whole u32s
    (b"\x00\x01\x02", np.zeros(1, "<u2").tobytes()),
])
def test_malformed_delta_entries_raise_base_mismatch(indices, values):
    for client, dm in ((None, dmsg), (ref_client, ref_dmsg)):
        state = (ref_client.DeltaPullState() if client
                 else DeltaPullState())
        state.note_full({"w": np.zeros(8, np.float32)}, 3)
        frames = [dm.DeltaFrame(
            from_version=3, to_version=4, delta=True,
            wire_dtype=m.WIRE_BF16, last=True,
            entries=[dm.DeltaEntry(name="w", indices=indices,
                                   values=values)])]
        with pytest.raises(ref_client.DeltaBaseMismatch if client
                           else DeltaBaseMismatch):
            (client.apply_frames if client else apply_frames)(
                iter(frames), state)


# ------------------------------------------------------ through the service
def make_service(core, tmp):
    return ParameterServerService(core, CheckpointManager(
        core, directory=str(tmp), checkpoint_interval=10**9,
        check_period_s=3600.0))


def delta_round(service, state, wire_dtype, iteration=0):
    """One PullParametersDelta round against the in-process service, each
    frame through its wire bytes."""
    req = dmsg.DeltaPullRequest(worker_id=0, iteration=iteration,
                                wire_dtype=wire_dtype,
                                held_version=max(state.version, 0))
    frames = [dmsg.DeltaFrame.decode(f.encode())
              for f in service.PullParametersDelta(req, None)]
    return apply_frames(iter(frames), state)


def full_pull(service, wire_dtype) -> dict:
    out = {}
    for chunk in service._parameter_chunks(0, wire_dtype):
        decoded = m.ParameterUpdate.decode(chunk.encode())
        out.update({t.name: t.to_array() for t in decoded.parameters})
    return out


def counters() -> tuple:
    snap = obs_stats.REGISTRY.snapshot()["counters"]
    return (snap.get("ps.serve.delta_hit", 0),
            snap.get("ps.serve.delta_miss", 0))


def grads(rng, scale=1e-3) -> dict:
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("stripes", [1, 3])
@pytest.mark.parametrize("chunk_bytes", [1 << 20, 96])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_chain_applied_deltas_bit_identical_to_full_pull(
        monkeypatch, tmp_path, dtype, chunk_bytes, stripes):
    monkeypatch.setenv("PSDT_DELTA_DTYPE", dtype)
    monkeypatch.setenv("PSDT_STREAM_CHUNK_BYTES", str(chunk_bytes))
    monkeypatch.setenv("PSDT_STRIPES", str(stripes))
    rng = np.random.default_rng(7)
    core = ParameterServerCore(total_workers=1, optimizer=SGD(0.5))
    service = make_service(core, tmp_path)
    core.initialize_parameters(_versions(1)[0])
    state = DeltaPullState()
    assert not delta_round(service, state, DTYPES[dtype]).served_delta
    served = 0
    for it in range(1, 5):
        core.receive_gradients(0, it, grads(rng))
        result = delta_round(service, state, DTYPES[dtype], it)
        served += result.served_delta
        oracle = full_pull(service, DTYPES[dtype])
        assert sorted(result.store) == sorted(oracle)
        for name in oracle:
            assert result.store[name].tobytes() == oracle[name].tobytes()
    # the first apply after the lazy arm reseeds; the rest are deltas
    assert served == 3


def test_depth_dtype_and_restore_fall_back_full_as_jax(monkeypatch,
                                                       tmp_path):
    """Side by side with the JAX service on one store sequence: a
    receiver past the depth, an f32 receiver of the bf16 chain and one
    behind a restore are each served in full, by both; after the
    restore neither serves a version it served before."""
    monkeypatch.setenv("PSDT_DELTA_DEPTH", "2")
    sides = []
    for port in (True, False):
        core = (ParameterServerCore(total_workers=1, optimizer=SGD(0.5))
                if port else RefCore(total_workers=1,
                                     optimizer=RefSGD(0.5)))
        manager = (CheckpointManager if port else RefCheckpointManager)(
            core, directory=str(tmp_path / str(port)),
            checkpoint_interval=10**9, check_period_s=3600.0)
        service = (ParameterServerService if port else RefService)(
            core, manager)
        sides.append((core, manager, service,
                      DeltaPullState() if port
                      else ref_client.DeltaPullState(), port))
    outcomes = {True: [], False: []}

    def round_(side, wire_dtype, state=None):
        core, _, service, own, port = side
        state = state or own
        if port:
            result = delta_round(service, state, wire_dtype)
        else:
            req = ref_dmsg.DeltaPullRequest(
                wire_dtype=wire_dtype, held_version=max(state.version, 0))
            frames = [ref_dmsg.DeltaFrame.decode(f.encode())
                      for f in service.PullParametersDelta(req, None)]
            result = ref_client.apply_frames(iter(frames), state)
        outcomes[port].append((result.served_delta, state.version))
        return result

    rng = np.random.default_rng(2)
    g = [grads(rng) for _ in range(6)]
    for side in sides:
        core, manager, service, state, port = side
        core.initialize_parameters(_versions(3)[0])
        manager.save(epoch=1)
        round_(side, m.WIRE_BF16)
        core.receive_gradients(0, 1, {k: v.copy() for k, v in g[0].items()})
        round_(side, m.WIRE_BF16)           # reseeded: full
        core.receive_gradients(0, 2, {k: v.copy() for k, v in g[1].items()})
        round_(side, m.WIRE_BF16)           # a delta
        behind = type(state)()
        behind.note_full({k: v.copy() for k, v in state.base.items()},
                         state.version)
        for it in (3, 4, 5):
            core.receive_gradients(0, it,
                                   {k: v.copy() for k, v in g[it].items()})
        round_(side, m.WIRE_BF16, behind)   # 3 behind at depth 2: full
        round_(side, m.WIRE_BF16)           # 3 behind too: full
        f32 = type(state)()
        round_(side, m.WIRE_F32, f32)
        core.receive_gradients(0, 6, {k: v.copy() for k, v in g[5].items()})
        round_(side, m.WIRE_F32, f32)       # another encoding: full
        round_(side, m.WIRE_BF16)           # a delta
        served_before = state.version
        manager.load(manager.latest())
        assert service.delta_chain.pairs_between(
            served_before, core.serve_version()) is None
        result = round_(side, m.WIRE_BF16)  # behind a restore: full
        assert not result.served_delta
        assert state.version > served_before
    assert outcomes[True] == outcomes[False]
    assert [d for d, _ in outcomes[True]] == [
        False, False, True, False, False, False, False, True, False]


def test_depth_zero_builds_no_chain(monkeypatch, tmp_path):
    monkeypatch.setenv("PSDT_DELTA_DEPTH", "0")
    core = ParameterServerCore(total_workers=1, optimizer=SGD(0.5))
    service = make_service(core, tmp_path)
    assert service.delta_chain is None
    core.initialize_parameters({"w": np.ones(8, np.float32)})
    result = delta_round(service, DeltaPullState(), m.WIRE_BF16)
    assert not result.served_delta and result.store is not None
    assert service.delta_report() == {"enabled": False, "armed": False,
                                      "published": []}


# ----------------------------------------------------- the core's publishers
def test_flat_close_feeds_the_chain_over_two_closes(monkeypatch):
    """The device close's flat path (sharded Adam on the CPU, both knobs
    on) publishes ArenaStores over host slabs; the chain's pairs equal
    those of a chain fed owned copies of the same stores, and a receiver
    following them holds each close's full decode."""
    monkeypatch.setenv("PSDT_DEVICE_APPLY", "1")
    monkeypatch.setenv("PSDT_ARENA", "1")
    rng = np.random.default_rng(5)
    core = ParameterServerCore(
        total_workers=1, stripes=2,
        optimizer=ShardedDeviceOptimizer("adam", 1e-3, device="cpu"))
    chain = tchain.DeltaChain(depth=4, wire_dtype=m.WIRE_BF16, stripes=2)
    copies = tchain.DeltaChain(depth=4, wire_dtype=m.WIRE_BF16, stripes=2)
    core.initialize_parameters(_versions(6)[0])
    core.set_delta_sink(chain)
    copies.note_apply(to_host(core.get_parameters()), core.params_version)
    decodes = []
    flat_before = obs_stats.counter("ps.apply.arena").value
    for it in (1, 2):
        # the push folded as decoded onto the device, as the service does
        sink = core.begin_push(0, it)
        sink.fold(decode_gradients(to_wire(grads(rng), m.WIRE_RAW_F32),
                                   torch.device("cpu")))
        assert sink.commit().aggregation_complete
        store = core._params
        assert isinstance(store, arena.ArenaStore)
        copies.note_apply({k: np.array(v) for k, v in store.items()},
                          core.params_version)
        decodes.append({k: m.Tensor.from_array(
            k, np.asarray(v), wire_dtype=m.WIRE_BF16).to_array()
            for k, v in store.items()})
    assert obs_stats.counter("ps.apply.arena").value - flat_before == 2
    top = core.params_version
    assert _pairs(chain, top) == _pairs(copies, top)
    state = DeltaPullState()
    state.note_full({k: m.Tensor.from_array(k, v, wire_dtype=m.WIRE_BF16)
                     .to_array() for k, v in _versions(6)[0].items()},
                    top - 2)
    for pair, want in zip(chain.pairs_between(top - 2, top), decodes):
        frames = [dmsg.DeltaFrame(
            from_version=pair.from_version, to_version=pair.to_version,
            delta=True, wire_dtype=m.WIRE_BF16, crc=pair.crc, last=True,
            entries=[dmsg.DeltaEntry(name=n, indices=i, values=v, dense=d)
                     for n, i, v, d in pair.entries])]
        result = apply_frames(iter(frames), state)
        for name in want:
            assert result.store[name].tobytes() == want[name].tobytes()


def test_async_apply_notifies_the_sink():
    """Port-only: an async core notes every apply (the JAX core notes
    only its bootstrap), so a subscriber of an async PS gets deltas."""
    rng = np.random.default_rng(8)
    core = ParameterServerCore(total_workers=1, optimizer=SGD(0.5),
                               staleness_bound=2)
    chain = tchain.DeltaChain(depth=4, wire_dtype=m.WIRE_BF16, stripes=1)
    core.set_delta_sink(chain)
    core.initialize_parameters(_versions(2)[0])
    for it in (1, 2, 3):
        core.receive_gradients(0, it, grads(rng))
    assert chain.version == core.params_version
    assert len(chain.pairs_between(chain.version - 3, chain.version)) == 3
    assert [p[0] for p in chain.published] == list(
        range(chain.version - 3, chain.version + 1))
