"""The port's decode fleet working with the JAX package's over loopback
gRPC, and the fleet CLIs as processes.  One wire, both ways: a port
decode server behind the JAX package's coordinator and router, a JAX
decode server behind the port's coordinator and router, and a fleet of
one of each, every routed stream token-exact against a single server
on the same converted store; ``ctl_main fleet`` (and ``fleet-drain``,
``scale``) printing what the JAX package's tool prints against one
coordinator, and its unported commands refused naming their item.
Last, the port's processes: ``cli.coordinator_main``, two
``cli.serve_main --serve-port=0 --coordinator=...`` and
``cli.route_main`` with jax and the JAX package blocked from import, a
stream through the router, ``ctl_main fleet-drain`` and SIGTERM, every
process exiting 0 with its report.  A tiny float32 model; every server
is stopped in teardown."""

import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu import config as jconfig
from parameter_server_distributed_tpu.cli import ctl_main as jctl_main
from parameter_server_distributed_tpu.fleet import decode as jdecode
from parameter_server_distributed_tpu.fleet import router as jrouter
from parameter_server_distributed_tpu.models import serving as js
from parameter_server_distributed_tpu.models import transformer as jt
from parameter_server_distributed_tpu.server import \
    coordinator_service as jcs
from parameter_server_distributed_tpu_torch import config as tconfig
from parameter_server_distributed_tpu_torch.cli import ctl_main
from parameter_server_distributed_tpu_torch.fleet import decode as tdecode
from parameter_server_distributed_tpu_torch.fleet import messages as tfm
from parameter_server_distributed_tpu_torch.fleet import router as trouter
from parameter_server_distributed_tpu_torch.models import serving as ts
from parameter_server_distributed_tpu_torch.models import transformer as tt
from parameter_server_distributed_tpu_torch.models.convert import \
    params_from_numpy
from parameter_server_distributed_tpu_torch.models.generation import generate
from parameter_server_distributed_tpu_torch.rpc.service import RpcClient
from parameter_server_distributed_tpu_torch.server import \
    coordinator_service as tcs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX store, port model, port store): one store."""
    jm = jt.Transformer(jt.TransformerConfig(
        vocab=VOCAB, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
        d_ff=64, max_seq=160, dtype=jnp.float32))
    fields = {f.name: getattr(jm.config, f.name)
              for f in dataclasses.fields(jm.config)}
    cfg = tt.TransformerConfig(**{**fields, "dtype": torch.float32})
    jparams = jm.init_params(0)
    store = {k: np.asarray(v) for k, v in jparams.items()}
    return jm, jparams, tt.Transformer(cfg), params_from_numpy(
        store, cfg, device="cpu")


def _server(models, side, sid, coordinator):
    jm, jparams, pm, params = models
    if side == "port":
        return tdecode.FleetDecodeServer(
            ts.DecodeServer(pm, params, slots=2, max_len=96, device="cpu"),
            server_id=sid, coordinator=coordinator, heartbeat_s=0.05)
    return jdecode.FleetDecodeServer(
        js.DecodeServer(jm, jparams, slots=2, max_len=96),
        server_id=sid, coordinator=coordinator, heartbeat_s=0.05)


def _coordinator(side):
    if side == "port":
        return tcs.Coordinator(tconfig.CoordinatorConfig(
            bind_address="127.0.0.1", port=0))
    return jcs.Coordinator(jconfig.CoordinatorConfig(
        bind_address="127.0.0.1", port=0))


def _router(side, caddr):
    cls = trouter.FleetRouter if side == "port" else jrouter.FleetRouter
    return cls(caddr, poll_s=0.05)


def _wait(cond, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError("condition never held")


@pytest.mark.parametrize("servers,control", [
    (("port",), "jax"), (("jax",), "port"), (("port", "jax"), "port"),
    (("jax", "port"), "jax")])
def test_mixed_fleet_streams_token_exact(models, servers, control):
    """``servers`` behind ``control``'s coordinator and router: every
    stream through the router token-exact against the port's generate
    and a single JAX DecodeServer on the same store, spread over every
    server."""
    jm, jparams, pm, params = models
    coordinator = _coordinator(control)
    caddr = f"127.0.0.1:{coordinator.start()}"
    fleet, router, client = [], None, None
    try:
        for sid, side in enumerate(servers):
            fleet.append(_server(models, side, sid, caddr))
            fleet[-1].start()
        _wait(lambda: sum(int(f.state) == tfm.MEMBER_ACTIVE
                          for f in coordinator.core.fleet_table()[1])
              == len(servers))
        router = _router(control, caddr)
        client = RpcClient(f"127.0.0.1:{router.start()}",
                           tfm.DECODE_SERVICE, tfm.DECODE_METHODS)
        rng = np.random.default_rng(len(servers))
        prompts = [[int(t) for t in rng.integers(0, VOCAB, int(n))]
                   for n in rng.integers(3, 12, 2 * len(servers))]
        calls = [client.call("SubmitStream", tfm.DecodeRequest(
            tokens=p, max_new=6, temperature=-1.0), timeout=60.0)
            for p in prompts]          # all in flight at once
        single = js.DecodeServer(jm, jparams, slots=1, max_len=96)
        for prompt, call in zip(prompts, calls):
            chunks = list(call)
            assert chunks[-1].done and not chunks[-1].error
            tokens = [int(c.token) for c in chunks if not c.done]
            want = [int(t) for t in generate(pm, params, [prompt], 6,
                                             device="cpu")[0]]
            rid = single.submit(prompt, 6)
            assert tokens == want == [int(t) for t in
                                      single.run_to_completion()[rid]]
        assert sum(s.streams_served for s in fleet) == len(prompts)
        assert all(s.streams_served for s in fleet)
    finally:
        if client is not None:
            client.close()
        if router is not None:
            router.stop()
        for server in fleet:
            server.stop()
        coordinator.stop()


@pytest.mark.parametrize("side", ["port", "jax"])
def test_ctl_fleet_prints_what_jax_prints(side, capsys):
    """Against one coordinator of either package, the port's
    ``fleet``, ``fleet-drain`` and ``scale`` print the JAX tool's lines
    and exit with its codes."""
    coordinator = _coordinator(side)
    caddr = f"127.0.0.1:{coordinator.start()}"
    try:
        core = coordinator.core
        core.fleet_register(0, "h:1", 4)
        core.fleet_register(3, "h:2", 8)
        core.fleet_heartbeat(3, 5, 2, 7, 3)
        printed = []
        for argv in (["fleet", caddr], ["scale", "2", caddr],
                     ["fleet", caddr], ["fleet-drain", "3", caddr],
                     ["fleet-drain", "42", caddr], ["fleet", caddr],
                     ["scale", "0", caddr]):
            rc = ctl_main.main(argv)
            got = capsys.readouterr().out
            # the JAX tool moves the coordinator the same way: undo the
            # port's step first so both see one state
            if argv[0] == "scale":
                core.set_fleet_target(0 if argv[1] != "0" else 2)
            if argv[0] == "fleet-drain" and rc == 0:
                core.fleet_register(3, "h:2", 8)
                core.fleet_heartbeat(3, 5, 2, 7, 3)
            jrc = jctl_main.main(argv)
            want = capsys.readouterr().out
            assert (rc, re.sub(r"epoch \d+", "epoch E", got)) == \
                (jrc, re.sub(r"epoch \d+", "epoch E", want)), argv
            printed.append(got)
        assert "server 3 [h:2]: draining, 5/8 slots free, queue 2, " \
               "version 7, 3 streams" in printed[5]
        assert "(2 servers, target 2)" in printed[2]
    finally:
        coordinator.stop()
    for command in ("drain", "members"):
        with pytest.raises(NotImplementedError, match="item 11"):
            ctl_main.main([command, "1", caddr])
    assert ctl_main.main([]) == 2


# runs a module as __main__ with jax and the JAX package blocked
BLOCKED_MAIN = """
import runpy, sys
BLOCKED = ("jax", "jaxlib", "parameter_server_distributed_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import of {name}")
sys.meta_path.insert(0, Block())
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


def _line(path, pattern, proc, deadline):
    while time.monotonic() < deadline:
        found = re.search(pattern, path.read_text())
        if found:
            return found.group(1)
        if proc.poll() is not None:
            break
        time.sleep(0.1)
    raise AssertionError(f"no {pattern!r} from {proc.args}: "
                         f"{path.read_text()[-3000:]}")


def test_fleet_clis_as_processes(tmp_path):
    """A coordinator, two decode servers in fleet mode and a router as
    processes (tiny_lm on the CPU): streams through the router are
    token-exact against generate, ``ctl_main fleet-drain 1`` drains
    server 1 to GONE and its process exits 0 by itself, SIGTERM drains
    the other, and the reports carry the streams and stats."""
    from parameter_server_distributed_tpu_torch.cli import generate_main

    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    mod = "parameter_server_distributed_tpu_torch.cli."
    procs = []

    def spawn(name, *args):
        log = tmp_path / f"{name}-{len(procs)}.log"
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-c", BLOCKED_MAIN, mod + name, *args],
                stdout=out, stderr=subprocess.STDOUT, env=env, cwd=tmp_path)
        procs.append(proc)
        return proc, log

    deadline = time.monotonic() + 100.0
    client = None
    try:
        coord, coord_log = spawn("coordinator_main", "127.0.0.1:0")
        caddr = "127.0.0.1:" + _line(
            coord_log, r"Coordinator server listening on [\d.]+:(\d+)",
            coord, deadline)
        servers = [spawn("serve_main", "--model=tiny_lm", "--device=cpu",
                         "--slots=2", "--max-len=64", "--prompt-cache=2",
                         "--serve-port=0", f"--coordinator={caddr}",
                         f"--server-id={sid}",
                         f"--report={tmp_path / f'serve{sid}.json'}")
                   for sid in (0, 1)]
        router, router_log = spawn("route_main", f"--coordinator={caddr}",
                                   "--poll-s=0.05",
                                   f"--report={tmp_path / 'route.json'}")
        rport = _line(router_log, r"fleet router on port (\d+)", router,
                      deadline)
        for proc, log in servers:
            _line(log, r"decode fleet server \d on port (\d+)", proc,
                  deadline)
        core_rows = []

        def both_active():
            resp = ctl_main._fleet_call(caddr, tfm.FleetRequest(
                server_id=-1, action=tfm.FLEET_QUERY))
            core_rows[:] = list(resp.entries)
            return sum(int(e.state) == tfm.MEMBER_ACTIVE
                       for e in resp.entries) == 2

        _wait(both_active, timeout=max(1.0, deadline - time.monotonic()))
        model = generate_main.build_model({"model": "tiny_lm"})
        params, _ = generate_main.load_params({}, model, 0, "cpu")
        client = RpcClient(f"127.0.0.1:{rport}", tfm.DECODE_SERVICE,
                           tfm.DECODE_METHODS)
        rng = np.random.default_rng(5)
        prompts = [[int(t) for t in rng.integers(0, 1024, n)]
                   for n in (5, 9, 7, 12)]
        calls = [client.call("SubmitStream", tfm.DecodeRequest(
            tokens=p, max_new=5, temperature=-1.0), timeout=60.0)
            for p in prompts]
        for prompt, call in zip(prompts, calls):
            chunks = list(call)
            assert chunks[-1].done and not chunks[-1].error
            assert [int(c.token) for c in chunks if not c.done] == \
                [int(t) for t in generate(model, params, [prompt], 5,
                                          device="cpu")[0]]
        assert ctl_main.main(["fleet-drain", "1", caddr]) == 0
        drained = servers[1][0]
        assert drained.wait(timeout=max(1.0, deadline - time.monotonic())) \
            == 0, servers[1][1].read_text()[-3000:]
        resp = ctl_main._fleet_call(caddr, tfm.FleetRequest(
            server_id=-1, action=tfm.FLEET_QUERY))
        assert [int(e.state) for e in resp.entries] == \
            [tfm.MEMBER_ACTIVE, tfm.MEMBER_GONE]
        time.sleep(0.1)  # one router poll past the leave
        chunks = list(client.call("SubmitStream", tfm.DecodeRequest(
            tokens=prompts[0], max_new=3, temperature=-1.0), timeout=60.0))
        assert chunks[-1].done and not chunks[-1].error
        for proc, _log in (servers[0], (router, router_log),
                           (coord, coord_log)):
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30.0) == 0, proc.args
    finally:
        if client is not None:
            client.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30.0)
    reports = [json.loads((tmp_path / f"serve{sid}.json").read_text())
               for sid in (0, 1)]
    assert sum(r["streams_served"] for r in reports) == 5
    assert all(r["streams_served"] for r in reports)
    assert sum(r["stats"]["requests_completed"] for r in reports) == 5
    assert all(n == 0 for r in reports for n in r["launches"].values())
    route = json.loads((tmp_path / "route.json").read_text())
    assert (route["streams_routed"], route["streams_rejected"]) == (5, 0)
