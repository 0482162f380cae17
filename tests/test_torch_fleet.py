"""The port's decode fleet (fleet/, the coordinator's fleet registry,
``UpdateFleet``, ``DecodeServer.swap_params``) on the CPU, against the
JAX package's: the fleet messages byte-equal both ways; the registry's
lifecycle (epochs, drain, leave, reap, manual target) equal under one
call sequence; ``score_backends``, ``occupancy``, ``scale_decision`` and
``expected_servers`` equal on seeded random tables; then the port's
fleet over loopback gRPC (a coordinator, decode servers on port 0, a
router): a routed stream token-exact against the port's ``generate``,
prefix-aware placement, the rolling update and the rollback pin read off
every chunk's version stamp, an abandoned stream's slot freed, the pin
kept through continued publication, a drifted store refused with the
last-good weights serving on, the coordinator-side drain, and the
autoscaler's drain-before-stop, as tests/test_fleet.py holds the JAX
package.  A tiny float32 model (max_len <= 160) on one intra-op thread;
every server is stopped in teardown."""

import dataclasses
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu.core import coordinator_core as jcc
from parameter_server_distributed_tpu.fleet import controller as jctl
from parameter_server_distributed_tpu.fleet import messages as jfm
from parameter_server_distributed_tpu.fleet import router as jrt
from parameter_server_distributed_tpu.models import transformer as jt
from parameter_server_distributed_tpu_torch.config import CoordinatorConfig
from parameter_server_distributed_tpu_torch.core import coordinator_core as tcc
from parameter_server_distributed_tpu_torch.fleet import controller as tctl
from parameter_server_distributed_tpu_torch.fleet import messages as tfm
from parameter_server_distributed_tpu_torch.fleet import router as trt
from parameter_server_distributed_tpu_torch.fleet.decode import \
    FleetDecodeServer
from parameter_server_distributed_tpu_torch.models import transformer as tt
from parameter_server_distributed_tpu_torch.models.convert import \
    params_from_numpy
from parameter_server_distributed_tpu_torch.models.generation import generate
from parameter_server_distributed_tpu_torch.models.prefix_tree import (
    block_hashes, pack_fp)
from parameter_server_distributed_tpu_torch.models.serving import DecodeServer
from parameter_server_distributed_tpu_torch.rpc.service import RpcClient
from parameter_server_distributed_tpu_torch.server.coordinator_service \
    import Coordinator

VOCAB = 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def model():
    """The port's tiny model and its store, converted from the JAX
    package's (tests/test_fleet.py's widths)."""
    jm = jt.Transformer(jt.TransformerConfig(
        vocab=VOCAB, d_model=32, n_heads=2, n_layers=2, d_ff=64,
        max_seq=160, dtype=jnp.float32))
    fields = {f.name: getattr(jm.config, f.name)
              for f in dataclasses.fields(jm.config)}
    cfg = tt.TransformerConfig(**{**fields, "dtype": torch.float32})
    store = {k: np.asarray(v) for k, v in jm.init_params(0).items()}
    return tt.Transformer(cfg), params_from_numpy(store, cfg, device="cpu")


def reference(model, prompt, n):
    pm, params = model
    return [int(t) for t in generate(pm, params, [prompt], n,
                                     device="cpu")[0]]


def prompt_of(rng, n):
    return [int(t) for t in rng.integers(1, VOCAB, n)]


# ------------------------------------------------------------- messages
def _messages(fm):
    fp = b"\x01\x00\x00\x00\x02\x00\x00\x00"
    return {
        "FleetRequest": fm.FleetRequest(
            server_id=3, action=fm.FLEET_HEARTBEAT, address="h:1",
            slots=8, free_slots=2, queue_depth=5, weight_version=7,
            active_streams=6, target_server_id=-1, scale_target=4,
            prefix_fp=fp, trace_context=b"\x07"),
        "FleetResponse": fm.FleetResponse(
            epoch=4, success=True, message="ok", self_state=-1,
            scale_target=2, entries=[
                fm.FleetEntry(server_id=1, address="h:2", slots=4,
                              free_slots=3, queue_depth=1,
                              weight_version=2, state=fm.MEMBER_DRAINING,
                              epoch=9, active_streams=1, prefix_fp=fp),
                fm.FleetEntry(server_id=-2, state=fm.MEMBER_GONE)]),
        "DecodeRequest": fm.DecodeRequest(tokens=[1, 2, 300], max_new=16,
                                          temperature=-1.0, stop=[7, 0]),
        "DecodeChunk": fm.DecodeChunk(request_id=9, token=42, done=True,
                                      error="server draining",
                                      weight_version=3),
        "DecodeControlRequest": fm.DecodeControlRequest(
            action=fm.CTRL_ROLLBACK, version=-1),
        "DecodeControlResponse": fm.DecodeControlResponse(
            success=False, message="version 5 not held", server_id=1,
            state=fm.MEMBER_ACTIVE, slots=8, free_slots=0,
            queue_depth=12, weight_version=1, pinned_version=-1,
            versions_held=[0, 1, 4], streams_served=77,
            prefill_tokens=1 << 40, prompt_tokens=5),
    }


@pytest.mark.parametrize("kind", sorted(_messages(tfm)))
def test_fleet_messages_byte_equal_jax_both_ways(kind):
    port, ref = _messages(tfm)[kind], _messages(jfm)[kind]
    data = port.encode()
    assert data == ref.encode()
    assert type(ref).decode(data).encode() == data
    assert type(port).decode(ref.encode()).encode() == data


def test_fleet_constants_and_method_tables_equal_jax():
    names = [n for n in dir(jfm) if n.startswith(("FLEET_", "CTRL_",
                                                  "MEMBER_"))]
    assert {n: getattr(tfm, n) for n in names if n != "FLEET_COORD_METHODS"
            } == {n: getattr(jfm, n) for n in names
                  if n != "FLEET_COORD_METHODS"}
    assert tfm.STATE_NAMES == jfm.STATE_NAMES
    assert tfm.DECODE_SERVICE == jfm.DECODE_SERVICE
    for table in ("FLEET_COORD_METHODS", "DECODE_METHODS"):
        got, want = getattr(tfm, table), getattr(jfm, table)
        assert sorted(got) == sorted(want)
        for method in want:
            assert [getattr(c, "__name__", c) for c in got[method]] == \
                [getattr(c, "__name__", c) for c in want[method]]


# ------------------------------------------------------------- registry
def _rows(table):
    epoch, rows, target = table
    return epoch, [dataclasses.astuple(r) for r in rows], target


def test_registry_lifecycle_equal_jax():
    """One call sequence on both cores, a fake clock: every return value
    and every table after each call equal."""
    now = [0.0]
    cores = [mod.CoordinatorCore("127.0.0.1", 1234, time_fn=lambda: now[0])
             for mod in (tcc, jcc)]
    steps = [
        ("fleet_register", (7, "h:1", 4), {}),
        ("fleet_register", (2, "h:2", 8), {}),
        ("fleet_heartbeat", (7,), dict(free_slots=1, queue_depth=3,
                                       weight_version=5, active_streams=3,
                                       prefix_fp=b"\x01\x02\x03\x04")),
        ("fleet_heartbeat", (2, 8, 0, 0, 0), {}),
        ("fleet_drain", (7,), {}),
        ("fleet_drain", (7,), {}),
        ("fleet_state", (7,), {}),
        ("fleet_leave", (7,), {}),
        ("fleet_heartbeat", (7, 4, 0, 0, 0), {}),
        ("fleet_drain", (7,), {}),
        ("fleet_drain", (42,), {}),
        ("fleet_leave", (42,), {}),
        ("fleet_state", (42,), {}),
        ("fleet_register", (7, "h:3", 2), {}),
        ("set_fleet_target", (3,), {}),
        ("set_fleet_target", (-1,), {}),
        ("tick", 10.0, {}),
        ("fleet_heartbeat", (2, 7, 1, 1, 1), {}),
        ("remove_stale_fleet", (5.0,), {}),
        ("remove_stale_fleet", (5.0,), {}),
        ("fleet_heartbeat", (7, 2, 0, 0, 0), {}),
        ("fleet_register", (7, "h:3", 2), {}),
    ]
    for name, args, kwargs in steps:
        if name == "tick":
            now[0] += args
            continue
        got = [getattr(core, name)(*args, **kwargs) for core in cores]
        assert got[0] == got[1], (name, args)
        assert _rows(cores[0].fleet_table()) == \
            _rows(cores[1].fleet_table()), (name, args)


def test_update_fleet_rpc_carries_the_registry():
    """UpdateFleet over loopback: register, a fingerprinted heartbeat,
    drain, scale target and query answer as the core holds them, and
    GetClusterMetrics is refused naming its item."""
    import grpc

    from parameter_server_distributed_tpu_torch.rpc import messages as m
    from parameter_server_distributed_tpu_torch.rpc.wire import Message

    coordinator = Coordinator(CoordinatorConfig(bind_address="127.0.0.1",
                                                port=0))
    address = f"127.0.0.1:{coordinator.start()}"
    client = RpcClient(address, m.COORDINATOR_SERVICE,
                       tfm.FLEET_COORD_METHODS)
    metrics = RpcClient(address, m.COORDINATOR_SERVICE,
                        {"GetClusterMetrics": (Message, Message)})
    try:
        def call(**kw):
            return client.call("UpdateFleet", tfm.FleetRequest(**kw),
                               timeout=5.0)

        call(server_id=0, action=tfm.FLEET_REGISTER, address="h:1",
             slots=4)
        beat = call(server_id=0, action=tfm.FLEET_HEARTBEAT, free_slots=3,
                    prefix_fp=b"\xaa\xbb\xcc\xdd")
        assert beat.success and beat.self_state == tfm.MEMBER_ACTIVE
        unknown = call(server_id=5, action=tfm.FLEET_HEARTBEAT)
        assert not unknown.success and unknown.self_state == -1
        assert call(server_id=-1, action=tfm.FLEET_DRAIN,
                    target_server_id=0).message == "server 0 draining"
        assert not call(server_id=-1, action=tfm.FLEET_DRAIN,
                        target_server_id=9).success
        scaled = call(server_id=-1, action=tfm.FLEET_SCALE, scale_target=3)
        assert scaled.scale_target == 3
        resp = call(server_id=-1, action=tfm.FLEET_QUERY)
        assert [(e.server_id, e.state, e.free_slots, bytes(e.prefix_fp))
                for e in resp.entries] == \
            [(0, tfm.MEMBER_DRAINING, 3, b"\xaa\xbb\xcc\xdd")]
        assert coordinator.core.fleet_table()[2] == 3
        with pytest.raises(grpc.RpcError) as err:
            metrics.call("GetClusterMetrics", Message(), timeout=5.0)
        assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
        assert "item 14" in err.value.details()
    finally:
        client.close()
        metrics.close()
        coordinator.stop()


# --------------------------------------------------------------- policy
def _table(fm, rng, n):
    states = [fm.MEMBER_ACTIVE] * 3 + [fm.MEMBER_DRAINING, fm.MEMBER_GONE,
                                       fm.MEMBER_JOINING]
    rows = []
    for sid in rng.permutation(n):
        slots = int(rng.integers(1, 9))
        blocks = [int(h) for h in rng.integers(0, 6, int(rng.integers(0, 4)))]
        rows.append(fm.FleetEntry(
            server_id=int(sid), address=f"h:{sid}", slots=slots,
            free_slots=int(rng.integers(0, slots + 1)),
            queue_depth=int(rng.integers(0, 4)),
            state=int(rng.choice(states)),
            prefix_fp=pack_fp(blocks) if blocks else b""))
    return rows


@pytest.mark.parametrize("seed", range(4))
def test_score_backends_equal_jax(seed):
    for trial in range(25):
        rng = np.random.default_rng((seed, trial))
        n = int(rng.integers(0, 7))
        rows = {fm: _table(fm, np.random.default_rng((seed, trial, 1)), n)
                for fm in (tfm, jfm)}
        claims = {int(s): int(c) for s, c in zip(
            rng.integers(0, 7, 3), rng.integers(0, 3, 3))}
        hashes = ([int(h) for h in rng.integers(0, 6, int(rng.integers(1,
                                                                      4)))]
                  if trial % 3 else None)
        weight = float(rng.choice([0.0, 0.5, 1.0, 2.0]))
        got = trt.score_backends(rows[tfm], claims, hashes, weight)
        want = jrt.score_backends(rows[jfm], claims, hashes, weight)
        assert [e.server_id for e in got] == [e.server_id for e in want]


@pytest.mark.parametrize("seed", range(4))
def test_scale_decision_and_sizing_equal_jax(seed):
    for trial in range(25):
        rng = np.random.default_rng((seed, trial))
        n = int(rng.integers(0, 7))
        rows = {fm: _table(fm, np.random.default_rng((seed, trial, 1)), n)
                for fm in (tfm, jfm)}
        low = float(rng.uniform(0.0, 0.5))
        kw = dict(low=low, high=float(rng.uniform(low, 1.2)),
                  min_servers=int(rng.integers(0, 3)),
                  max_servers=int(rng.integers(3, 6)))
        manual = int(rng.choice([0, 0, 2, 9]))
        assert tctl.occupancy(rows[tfm]) == jctl.occupancy(rows[jfm])
        assert tctl.scale_decision(rows[tfm], tctl.ScalePolicy(**kw),
                                   manual) == \
            jctl.scale_decision(rows[jfm], jctl.ScalePolicy(**kw), manual)
        sizing = (float(rng.uniform(0, 50)), float(rng.uniform(1, 200)),
                  float(rng.choice([0.0, rng.uniform(1, 100)])),
                  int(rng.integers(0, 16)))
        assert tctl.expected_servers(*sizing) == \
            jctl.expected_servers(*sizing)


@pytest.mark.parametrize("weight,first", [(0.0, 0), (1.0, 1), (2.5, 1)])
def test_router_scores_with_its_overlap_weight(weight, first):
    """A FleetRouter's admissions rank by score_backends with the
    router's overlap_weight, its claims debited pick by pick, as the JAX
    package's score ranks the same table: server 0 has more free slots,
    server 1 holds the prompt's first three blocks."""
    prompt = list(range(1, 70))
    hashes = block_hashes(prompt)
    rows = {fm: [fm.FleetEntry(server_id=0, address="h:0", slots=8,
                               free_slots=4, state=fm.MEMBER_ACTIVE),
                 fm.FleetEntry(server_id=1, address="h:1", slots=8,
                               free_slots=2, state=fm.MEMBER_ACTIVE,
                               prefix_fp=pack_fp(hashes[:3]))]
            for fm in (tfm, jfm)}
    router = trt.FleetRouter("127.0.0.1:1", poll_s=3600.0,
                             overlap_weight=weight)
    try:
        router._entries = rows[tfm]
        router._table_at = time.monotonic()   # a fresh table: no poll
        claims: dict[int, int] = {}
        picks, want = [], []
        for _ in range(4):
            picks.append(int(router._pick_backend(prompt)[0].server_id))
            best = int(jrt.score_backends(rows[jfm], claims, hashes,
                                          weight)[0].server_id)
            claims[best] = claims.get(best, 0) + 1
            want.append(best)
    finally:
        router.stop()
    assert picks == want and picks[0] == first


# ---------------------------------------------------------- swap_params
def test_swap_params_refuses_drift_and_clears_prefix_tree(model):
    pm, params = model
    srv = DecodeServer(pm, params, slots=2, max_len=64, prompt_cache=4,
                       device="cpu")
    prompt = list(range(1, 21))   # one fingerprint block and more
    rid = srv.submit(prompt, max_new_tokens=3)
    assert srv.run_to_completion()[rid] == reference(model, prompt, 3)
    assert srv._prefix_tree.nodes > 0 and srv.prefix_fingerprint() != b""
    drifted = dict(params)
    name = next(iter(drifted))
    drifted[name] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="drift"):
        srv.swap_params(drifted, version=1)
    missing = {k: v for k, v in params.items() if k != name}
    with pytest.raises(ValueError, match="drift"):
        srv.swap_params(missing, version=1)
    assert srv.params is params and srv.params_version == 0
    assert "weight_swaps" not in srv.stats
    # an in-flight request keeps its slot, rows and tokens through a swap
    rid = srv.submit(prompt, max_new_tokens=4)
    srv.step()
    srv.swap_params({k: v.clone() for k, v in params.items()}, version=3)
    assert srv._prefix_tree.nodes == 0 and srv.prefix_fingerprint() == b""
    assert srv.params_version == 3 and srv.stats["weight_swaps"] == 1
    assert srv.run_to_completion()[rid] == reference(model, prompt, 4)


# -------------------------------------------------------- the fleet, live
class _Fleet:
    """A coordinator, N FleetDecodeServers and a router on loopback,
    torn down in reverse order."""

    def __init__(self, model, n, slots=4, prompt_cache=0, heartbeat_s=0.05,
                 round_delay_s=0.0):
        pm, params = model
        self.coordinator = Coordinator(CoordinatorConfig(
            bind_address="127.0.0.1", port=0))
        self.caddr = f"127.0.0.1:{self.coordinator.start()}"
        self.servers, self.router, self.client = [], None, None
        self.controller = tctl.FleetController(self.coordinator.core)
        try:
            for sid in range(n):
                server = FleetDecodeServer(
                    DecodeServer(pm, params, slots=slots, max_len=160,
                                 prompt_cache=prompt_cache, device="cpu"),
                    server_id=sid, coordinator=self.caddr,
                    heartbeat_s=heartbeat_s)
                if round_delay_s:
                    slow_rounds(server, round_delay_s)
                server.start()
                self.servers.append(server)
            wait_for(lambda: sum(
                f.state == tfm.MEMBER_ACTIVE
                for f in self.coordinator.core.fleet_table()[1]) == n)
            self.router = trt.FleetRouter(self.caddr, poll_s=0.05)
            self.client = RpcClient(f"127.0.0.1:{self.router.start()}",
                                    tfm.DECODE_SERVICE, tfm.DECODE_METHODS)
        except BaseException:
            self.close()
            raise

    def stream(self, prompt, max_new=6):
        """Submit through the router: (tokens, versions, error)."""
        chunks = list(self.client.call(
            "SubmitStream",
            tfm.DecodeRequest(tokens=prompt, max_new=max_new,
                              temperature=-1.0), timeout=60.0))
        assert chunks and chunks[-1].done
        return ([int(c.token) for c in chunks if not c.done],
                [int(c.weight_version) for c in chunks if not c.done],
                chunks[-1].error)

    def close(self):
        self.controller.close()
        if self.client is not None:
            self.client.close()
        if self.router is not None:
            self.router.stop()
        for server in self.servers:
            server.stop()
        self.coordinator.stop()


def slow_rounds(server, delay_s):
    """Give each of ``server``'s decode rounds a service time, so a tiny
    model's streams stay in flight long enough for a rollout or a drain
    to land mid-stream."""
    step = server.server.step

    def slow_step():
        emitted = step()
        time.sleep(delay_s)
        return emitted

    server.server.step = slow_step


def wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError("condition never held")


@pytest.fixture
def fleet2(model):
    fleet = _Fleet(model, 2)
    yield fleet
    fleet.close()


def test_routed_streams_token_exact_spread_and_pinned(fleet2, model):
    rng = np.random.default_rng(1)
    prompts = [prompt_of(rng, int(n)) for n in rng.integers(3, 9, 6)]
    results = [None] * len(prompts)

    def drive(i):
        results[i] = fleet2.stream(prompts[i], max_new=6)

    threads = [threading.Thread(target=drive, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=60.0)
        assert not thread.is_alive()
    for prompt, (tokens, versions, error) in zip(prompts, results):
        assert not error and tokens == reference(model, prompt, 6)
        assert set(versions) == {0}
    served = [s.streams_served for s in fleet2.servers]
    assert sum(served) == 6 and all(served), served
    # a bad request is an error chunk, and the fleet serves on
    assert "empty prompt" in fleet2.stream([], max_new=4)[2]
    resp = fleet2.client.call("Control", tfm.DecodeControlRequest(
        action=tfm.CTRL_STATUS), timeout=5.0)
    assert resp.success and resp.streams_served == 7 and resp.slots == 8


def test_router_prefers_backend_with_cached_prefix(model):
    fleet = _Fleet(model, 2, prompt_cache=8)
    try:
        rng = np.random.default_rng(2)
        shared = prompt_of(rng, 18)
        first = shared + prompt_of(rng, 3)
        tokens, _v, error = fleet.stream(first, max_new=4)
        assert not error and tokens == reference(model, first, 4)
        warm = next(s for s in fleet.servers if s.streams_served == 1)
        wait_for(lambda: any(
            m.server_id == warm.server_id and m.prefix_fp
            for m in fleet.coordinator.core.fleet_table()[1]))
        time.sleep(0.1)  # one router poll past the fingerprint
        second = shared + prompt_of(rng, 4)
        tokens, _v, error = fleet.stream(second, max_new=4)
        assert not error and tokens == reference(model, second, 4)
        assert warm.streams_served == 2, "the router ignored the warm cache"
        assert warm.server.stats["prefix_hits"] == 1
    finally:
        fleet.close()


def test_router_keeps_claims_until_a_heartbeat_shows_them(model):
    """A burst of 4 long streams, 100 ms apart, through a router polling
    every 10 ms onto two 2-slot servers that heartbeat every 30 s (once,
    at registration, in this test): every poll lands mid-burst on a
    table that shows no admission.  The port's router, told the fleet's
    heartbeat period, keeps its claims until a heartbeat could show them
    and places 2 and 2; the JAX package's router, beside it on the same
    fleet, clears them at each poll and stacks the burst on server 0
    (all four when each admission's poll lands before the next; an
    admission during a poll routes on the old table and its claims, so
    a loaded host may see three)."""
    fleet = _Fleet(model, 2, slots=2, heartbeat_s=30.0, round_delay_s=0.01)
    try:
        placements = {}
        for side, router in (
                ("port", trt.FleetRouter(fleet.caddr, poll_s=0.01,
                                         heartbeat_s=30.0)),
                ("jax", jrt.FleetRouter(fleet.caddr, poll_s=0.01))):
            client = RpcClient(f"127.0.0.1:{router.start()}",
                               tfm.DECODE_SERVICE, tfm.DECODE_METHODS)
            before = [s.streams_served for s in fleet.servers]
            errors = []

            def drive(i):
                chunks = list(client.call("SubmitStream", tfm.DecodeRequest(
                    tokens=[1 + i, 2, 3], max_new=60), timeout=60.0))
                errors.append(chunks[-1].error)

            threads = [threading.Thread(target=drive, args=(i,),
                                        daemon=True) for i in range(4)]
            try:
                for thread in threads:
                    thread.start()
                    time.sleep(0.1)
                for thread in threads:
                    thread.join(timeout=60.0)
                    assert not thread.is_alive()
            finally:
                client.close()
                router.stop()
            assert errors == [""] * 4
            placements[side] = [s.streams_served - b
                                for s, b in zip(fleet.servers, before)]
        assert placements["port"] == [2, 2], placements
        assert placements["jax"][0] >= 3, placements
    finally:
        fleet.close()


def test_router_credits_ended_streams_until_the_table_shows_them():
    """Two streams that ran on server 0 ended after its last heartbeat,
    which still shows both slots taken: the port's router counts them
    free again (a credit each, until a table a heartbeat newer holds the
    end) and places the next stream there, where the JAX package's
    score, on the heartbeat alone, sends it to server 1."""
    rows = {fm: [fm.FleetEntry(server_id=0, address="h:0", slots=2,
                               free_slots=0, state=fm.MEMBER_ACTIVE),
                 fm.FleetEntry(server_id=1, address="h:1", slots=2,
                               free_slots=1, state=fm.MEMBER_ACTIVE)]
            for fm in (tfm, jfm)}
    router = trt.FleetRouter("127.0.0.1:1", poll_s=3600.0, heartbeat_s=1.0)
    try:
        router._entries = rows[tfm]
        router._table_at = router._table_asked = time.monotonic()
        for _ in range(2):
            _, claim = router._pick_backend()
            claim[0] = 0                  # both ran on server 0
            router._admitted(claim)
            router._release(claim)
        assert router._claims_locked() == {0: -2}
        assert int(router._pick_backend()[0].server_id) == 0
        assert int(jrt.score_backends(rows[jfm], {})[0].server_id) == 1
        # a table that shows the slots free again: the credits free
        # nothing more and cancel no new claim, so picks alternate
        router._entries = [tfm.FleetEntry(
            server_id=sid, address=f"h:{sid}", slots=2, free_slots=2,
            state=tfm.MEMBER_ACTIVE) for sid in (0, 1)]
        assert router._claims_locked() == {0: 1}
        assert [int(router._pick_backend()[0].server_id)
                for _ in range(3)] == [1, 0, 1]
        # a table asked for after the credits' time holds the ends; the
        # picks' claims stay until their streams are admitted and shown
        router._table_asked = time.monotonic() + 10.0
        assert router._claims_locked() == {0: 2, 1: 2}
    finally:
        router.stop()


def test_empty_fleet_rejects_instead_of_hanging():
    coordinator = Coordinator(CoordinatorConfig(bind_address="127.0.0.1",
                                                port=0))
    router = trt.FleetRouter(f"127.0.0.1:{coordinator.start()}",
                             poll_s=0.05)
    client = RpcClient(f"127.0.0.1:{router.start()}", tfm.DECODE_SERVICE,
                       tfm.DECODE_METHODS)
    try:
        chunks = list(client.call("SubmitStream", tfm.DecodeRequest(
            tokens=[1, 2], max_new=4), timeout=10.0))
        assert chunks[-1].error and chunks[-1].done
        assert router.streams_rejected == 1 and router.streams_routed == 0
    finally:
        client.close()
        router.stop()
        coordinator.stop()


def test_rolling_update_and_rollback_version_stamps(model):
    """A stream rides a mid-fleet rollout to version 1 (its stamps run
    0...0 1...1, nothing dropped); after a rollback pinned at 1 no chunk
    carries version 2 until unpinned; a version not held is refused."""
    fleet = _Fleet(model, 2, round_delay_s=0.01)
    try:
        rng = np.random.default_rng(3)
        store = {k: v.clone() for k, v in model[1].items()}
        for server in fleet.servers:
            server.publish_version(store, 1)
        result = {}
        prompt = prompt_of(rng, 5)

        def long_stream():
            result["out"] = fleet.stream(prompt, max_new=60)

        thread = threading.Thread(target=long_stream, daemon=True)
        thread.start()
        wait_for(lambda: any(s.server.active for s in fleet.servers))
        time.sleep(0.05)
        assert all(fleet.controller.rolling_update(1).values())
        thread.join(timeout=60.0)
        tokens, versions, error = result["out"]
        assert not error and tokens == reference(model, prompt, 60)
        assert versions[0] == 0 and versions[-1] == 1
        assert versions == sorted(versions), versions
        for server in fleet.servers:
            server.publish_version(store, 2)
        assert all(fleet.controller.rollback(1).values())
        for _ in range(3):
            _t, versions, error = fleet.stream(prompt_of(rng, 4), max_new=5)
            assert not error and set(versions) == {1}
        assert not any(fleet.controller.rolling_update(2).values())
        assert not any(fleet.controller.rolling_update(99).values())
        fleet.controller.unpin()
        assert all(fleet.controller.rolling_update(2).values())
        _t, versions, _e = fleet.stream([1, 2, 3], max_new=4)
        assert set(versions) == {2}
        assert all(s.server.stats["weight_swaps"] == 2   # 1, then 2
                   for s in fleet.servers)
    finally:
        fleet.close()


def test_coordinator_drain_finishes_streams_then_leaves(fleet2, model):
    target = fleet2.servers[1]
    result = {}
    prompt = [5, 9, 11, 2]
    direct = RpcClient(target.address, tfm.DECODE_SERVICE,
                       tfm.DECODE_METHODS)
    try:
        def long_stream():
            chunks = list(direct.call("SubmitStream", tfm.DecodeRequest(
                tokens=prompt, max_new=30, temperature=-1.0),
                timeout=60.0))
            result["tokens"] = [c.token for c in chunks if not c.done]
            result["error"] = chunks[-1].error

        slow_rounds(target, 0.01)
        thread = threading.Thread(target=long_stream, daemon=True)
        thread.start()
        wait_for(lambda: target.server.active == 1)
        assert fleet2.coordinator.core.fleet_drain(1)
        assert target.wait_drained(30.0), "the drain never completed"
        thread.join(timeout=30.0)
        assert not result["error"]
        assert result["tokens"] == reference(model, prompt, 30)
        assert fleet2.coordinator.core.fleet_state(1) == tfm.MEMBER_GONE
        chunks = list(direct.call("SubmitStream", tfm.DecodeRequest(
            tokens=[1, 2], max_new=2), timeout=10.0))
        assert chunks[-1].error == "server draining"
    finally:
        direct.close()
    time.sleep(0.1)  # one router poll past the leave
    tokens, _v, error = fleet2.stream([3, 4, 5], max_new=4)
    assert not error and len(tokens) == 4
    assert fleet2.servers[0].streams_served == 1


def test_abandoned_stream_frees_its_slot(model):
    pm, params = model
    server = FleetDecodeServer(
        DecodeServer(pm, params, slots=1, max_len=160, device="cpu"),
        server_id=0, heartbeat_s=0.05)
    slow_rounds(server, 0.02)
    server.start()
    client = RpcClient(server.address, tfm.DECODE_SERVICE,
                       tfm.DECODE_METHODS)
    try:
        chunks = client.call("SubmitStream", tfm.DecodeRequest(
            tokens=[4, 5, 6, 7], max_new=150, temperature=-1.0),
            timeout=None)
        next(chunks)
        chunks.cancel()
        wait_for(lambda: server.server.active == 0)
        out = list(client.call("SubmitStream", tfm.DecodeRequest(
            tokens=[4, 5, 6, 7], max_new=3, temperature=-1.0),
            timeout=30.0))
        assert out[-1].done and not out[-1].error
        assert [c.token for c in out if not c.done] == \
            reference(model, [4, 5, 6, 7], 3)
    finally:
        client.close()
        server.stop()


def test_pin_survives_publication_and_drift_is_refused(model):
    """The rollback pin is never evicted from the bounded store; a
    drifted store is held but its swap fails, and the last-good weights
    serve on; a standalone server advances to each version itself."""
    pm, params = model
    server = FleetDecodeServer(
        DecodeServer(pm, params, slots=1, max_len=160, device="cpu"),
        server_id=0, versions_kept=2, heartbeat_s=0.05)
    server.start()
    try:
        store = {k: v.clone() for k, v in params.items()}
        server.publish_version(store, 1)
        wait_for(lambda: server.weight_version() == 1)  # auto-advance
        resp = server.Control(tfm.DecodeControlRequest(
            action=tfm.CTRL_ROLLBACK, version=1), None)
        assert resp.success and resp.pinned_version == 1
        for version in (2, 3, 4, 5):
            server.publish_version(store, version)
        resp = server.Control(tfm.DecodeControlRequest(
            action=tfm.CTRL_STATUS), None)
        assert 1 in resp.versions_held and len(resp.versions_held) == 2
        assert server.weight_version() == 1
        server.Control(tfm.DecodeControlRequest(action=tfm.CTRL_UNPIN),
                       None)
        bad = {name: torch.zeros(3, 3) for name in params}
        server.publish_version(bad, 7)
        resp = server.Control(tfm.DecodeControlRequest(
            action=tfm.CTRL_SWAP, version=7), None)
        assert not resp.success and "failed" in resp.message
        assert server.weight_version() == 1
        assert not server.Control(tfm.DecodeControlRequest(
            action=tfm.CTRL_SWAP, version=99), None).success
        client = RpcClient(server.address, tfm.DECODE_SERVICE,
                           tfm.DECODE_METHODS)
        try:
            out = list(client.call("SubmitStream", tfm.DecodeRequest(
                tokens=[1, 2, 3], max_new=3, temperature=-1.0),
                timeout=30.0))
        finally:
            client.close()
        assert [c.token for c in out if not c.done] == \
            reference(model, [1, 2, 3], 3)
        assert {c.weight_version for c in out} == {1}
    finally:
        server.stop()


class _Feed:
    """A follower stand-in: hands out one queued version per poll."""

    def __init__(self, versions):
        self.versions = list(versions)
        self.stopped = False

    def poll(self):
        return self.versions.pop(0) if self.versions else None

    def stop(self):
        self.stopped = True


def test_follower_refused_naming_its_item(model):
    """``follower=`` is ported (it was refused naming item 12): the
    server polls the feed at its round boundaries, swaps each version it
    delivers and stops the feed with itself."""
    pm, params = model
    srv = DecodeServer(pm, params, slots=1, max_len=32, device="cpu")
    fresh = {k: v.clone() for k, v in params.items()}
    feed = _Feed([(fresh, 3)])
    fds = FleetDecodeServer(srv, follower=feed, heartbeat_s=0.02)
    fds.start()
    try:
        deadline = time.monotonic() + 10
        while fds.weight_version() != 3:
            assert time.monotonic() < deadline, "the fed version never swapped"
            time.sleep(0.02)
        assert srv.params is fresh and [v for v, _ in fds.swaps] == [3]
    finally:
        fds.stop()
    assert feed.stopped


# ------------------------------------------------------------ autoscaler
class _FakeSpawner:
    def __init__(self):
        self.spawned = 0
        self.stopped = []

    def spawn(self):
        self.spawned += 1

    def stop(self, server_id):
        self.stopped.append(server_id)


def test_autoscaler_scale_out_and_drain_before_stop():
    core = tcc.CoordinatorCore("127.0.0.1", 1234)
    core.fleet_register(0, "h:1", 4)
    core.fleet_heartbeat(0, free_slots=0, queue_depth=4, weight_version=0,
                         active_streams=4)
    spawner = _FakeSpawner()
    controller = tctl.FleetController(
        core, spawner=spawner,
        policy=tctl.ScalePolicy(low=0.3, high=0.8, max_servers=4))
    try:
        assert controller.scale_step() == 2 and spawner.spawned == 1
        core.fleet_register(1, "h:2", 4)
        core.fleet_heartbeat(1, 3, 0, 0, 1)
        core.fleet_heartbeat(0, 1, 0, 0, 3)
        assert controller.scale_step() == 2 and spawner.spawned == 1
        for sid in (0, 1):
            core.fleet_heartbeat(sid, 4, 0, 0, 0)
        assert controller.scale_step() == 1
        assert core.fleet_state(1) == tfm.MEMBER_DRAINING
        assert controller.scale_step() == 1 and spawner.stopped == []
        core.fleet_leave(1)
        controller.scale_step()
        assert spawner.stopped == [1]
        controller._interval = 0.01
        controller.start_autoscaler()
        time.sleep(0.05)
    finally:
        controller.close()
    assert controller._thread is None
