"""The PyTorch port stands alone: it imports neither ``jax`` nor the JAX
package, and its entry points run on the CUDA card unless the caller asks
for the CPU (the PS optimizer factory degrades to the host optimizer
instead, and counts it, as the reference's does)."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "parameter_server_distributed_tpu_torch")
BLOCKED = ("jax", "jaxlib", "parameter_server_distributed_tpu")


def _port_sources():
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in filenames:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "k5_compare.py")
    yield os.path.join(REPO, "resnet_grad_conditioning.py")
    yield os.path.join(REPO, "config3_probe.py")


def _blocked(module: str) -> bool:
    return any(module == b or module.startswith(b + ".") for b in BLOCKED)


def test_no_jax_import_in_port_sources():
    found = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                      for n in names if _blocked(n)]
    assert found == []


def test_fleet_and_elastic_modules_are_scanned():
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    assert {os.path.join("elastic", "messages.py"),
            os.path.join("fleet", "__init__.py"),
            os.path.join("fleet", "messages.py"),
            os.path.join("fleet", "decode.py"),
            os.path.join("fleet", "router.py"),
            os.path.join("fleet", "controller.py"),
            os.path.join("cli", "route_main.py"),
            os.path.join("cli", "ctl_main.py")} <= scanned


def test_delta_modules_are_scanned():
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    assert {os.path.join("delta", name) for name in (
        "__init__.py", "messages.py", "chain.py", "client.py",
        "subscriber.py")} <= scanned


def test_sharding_modules_are_scanned():
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    assert {os.path.join("replication", "__init__.py"),
            os.path.join("replication", "messages.py"),
            os.path.join("replication", "failover.py"),
            os.path.join("worker", "ps_shards.py")} <= scanned


def test_image_and_data_modules_are_scanned():
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    assert {os.path.join("models", "resnet.py"),
            os.path.join("models", "vit.py"),
            os.path.join("data", "files.py"),
            os.path.join("data", "text.py")} <= scanned


def test_name_match_is_whole_name():
    assert _blocked("jax.numpy") and _blocked("parameter_server_distributed_tpu")
    assert not _blocked("parameter_server_distributed_tpu_torch.models")
    assert not _blocked("jaxtyping")


def test_port_imports_and_serves_with_jax_blocked():
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys

        BLOCKED = {BLOCKED!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".")
                       for b in BLOCKED):
                    raise ImportError(f"blocked import of {{name}}")
                return None

        sys.meta_path.insert(0, Block())
        import torch
        torch.set_num_threads(2)   # tiny models: more threads cost time
        import parameter_server_distributed_tpu_torch as port
        for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
            importlib.import_module(info.name)
        from parameter_server_distributed_tpu_torch.models.registry import \\
            get_model
        from parameter_server_distributed_tpu_torch.models.serving import \\
            DecodeServer
        model = get_model("tiny_lm")
        srv = DecodeServer(model, model.init_params(0, device="cpu"),
                           slots=1, max_len=32, device="cpu")
        rid = srv.submit([1, 2, 3], max_new_tokens=4)
        assert len(srv.run_to_completion()[rid]) == 4
        # int8 weights, the int8 cache and the prefix cache
        from parameter_server_distributed_tpu_torch.models.quant import \
            quantize_params
        srv = DecodeServer(model, quantize_params(model.init_params(
            0, device="cpu")), slots=1, max_len=32, device="cpu",
            cache_dtype="int8", prompt_cache=2)
        for prompt in ([1, 2, 3], [1, 2, 3, 4]):
            rid = srv.submit(prompt, max_new_tokens=4)
            assert len(srv.run_to_completion()[rid]) == 4
        assert srv.stats["prefix_hits"] == 1
        # one training round: worker step, then the PS apply
        from parameter_server_distributed_tpu_torch.async_sgd import \\
            device_optimizer
        from parameter_server_distributed_tpu_torch.models.registry import \\
            get_model_and_batches
        from parameter_server_distributed_tpu_torch.worker.trainer import \\
            Trainer
        model, batches = get_model_and_batches("tiny_lm", 2, device="cpu")
        trainer = Trainer(model, device="cpu")
        params = trainer.init_params(0)
        grads, loss = trainer.compute_gradients(params, next(batches))
        opt = device_optimizer.PallasOptimizer("adam", 1e-3, device="cpu")
        new = opt.apply(params, grads)
        assert loss > 0 and sorted(new) == sorted(params)
        # the image rows build, and a tiny ResNet takes a step
        for name in ("resnet18_cifar", "vit_tiny_cifar"):
            image_model, images = get_model_and_batches(name, 2,
                                                        device="cpu")
            x, y = next(images)
            assert x.shape == (2, 32, 32, 3)
            assert image_model.num_params() > 2e6
        from parameter_server_distributed_tpu_torch.models.resnet import \
            ResNet
        tiny = ResNet((1, 1), width=8)
        image_trainer = Trainer(tiny, device="cpu")
        image_grads, image_loss = image_trainer.compute_gradients(
            image_trainer.init_params(0), (x[:, :8, :8], y))
        assert image_loss > 0
        assert sorted(image_grads) == sorted(tiny.param_shapes())
        # a two-worker, two-round PS session: coordinator, core, the
        # fused Adam apply, a checkpoint of the result
        import tempfile
        from parameter_server_distributed_tpu_torch.checkpoint.manager \
            import CheckpointManager
        from parameter_server_distributed_tpu_torch.core.coordinator_core \
            import CoordinatorCore
        from parameter_server_distributed_tpu_torch.core.optimizer import \
            make_optimizer
        from parameter_server_distributed_tpu_torch.core.ps_core import \
            ParameterServerCore
        coord = CoordinatorCore("127.0.0.1", 50051)
        for wid in (0, 1):
            coord.register_worker(wid, "127.0.0.1", 6000 + wid, "h")
        ps = ParameterServerCore(
            total_workers=2, live_workers_fn=coord.width_provider(),
            optimizer=make_optimizer("pallas_adam", 1e-3, device="cpu"))
        ps.initialize_parameters(params)
        batch = next(batches)
        for it in (1, 2):
            for wid in (0, 1):
                served = ps.serve_parameters(it)[1]
                grads, _ = trainer.compute_gradients(served, batch)
                result = ps.receive_gradients(wid, it, grads)
            assert result.aggregation_complete
        with tempfile.TemporaryDirectory() as d:
            CheckpointManager(ps, d).save()
        # one fused round over the shared-memory rings: the port's PS at
        # its default optimizer, an mnist_mlp step, bf16 on the wire
        import os
        os.environ["PSDT_SHM"] = "1"
        from parameter_server_distributed_tpu_torch import config
        from parameter_server_distributed_tpu_torch.rpc import data_plane
        from parameter_server_distributed_tpu_torch.rpc import \
            messages as msgs
        from parameter_server_distributed_tpu_torch.server.ps_service \
            import ParameterServer
        with tempfile.TemporaryDirectory() as d:
            server = ParameterServer(config.ParameterServerConfig(
                bind_address="127.0.0.1", port=0, total_workers=1,
                checkpoint_dir=d, learning_rate=0.1, device="cpu"))
            address = f"127.0.0.1:{{server.start()}}"
            try:
                model, batches = get_model_and_batches("mnist_mlp", 8,
                                                       device="cpu")
                trainer = Trainer(model, device="cpu")
                store = trainer.init_params(0)
                server.core.initialize_parameters(store)
                grads, _ = trainer.compute_gradients(store, next(batches))
                client = data_plane.PSClient(address)
                try:
                    push, fresh = client.push_pull(
                        0, 0, [msgs.Tensor.from_array(
                            n, g, wire_dtype=msgs.WIRE_BF16)
                            for n, g in grads.items()],
                        pull_wire_dtype=msgs.WIRE_BF16, timeout=60)
                    assert push.success and fresh is not None
                    assert client.shm_active
                finally:
                    client.close()
                # a weight follower of the PS gets its version
                from parameter_server_distributed_tpu_torch.delta \
                    .subscriber import WeightFollower
                follower = WeightFollower(address).start()
                try:
                    got = follower.wait_for_update(timeout=60)
                    assert got is not None
                    assert got[1] == server.core.serve_version()
                finally:
                    follower.stop()
            finally:
                server.stop()
        # a decode fleet in process: coordinator, server, router, stream
        from parameter_server_distributed_tpu_torch.fleet import \
            messages as fmsg
        from parameter_server_distributed_tpu_torch.fleet.decode import \
            FleetDecodeServer
        from parameter_server_distributed_tpu_torch.fleet.router import \
            FleetRouter
        from parameter_server_distributed_tpu_torch.rpc.service import \
            RpcClient
        from parameter_server_distributed_tpu_torch.server \
            .coordinator_service import Coordinator
        coordinator = Coordinator(config.CoordinatorConfig(
            bind_address="127.0.0.1", port=0))
        caddr = f"127.0.0.1:{{coordinator.start()}}"
        model = get_model("tiny_lm")
        fleet = FleetDecodeServer(DecodeServer(
            model, model.init_params(0, device="cpu"), slots=1, max_len=32,
            device="cpu"), coordinator=caddr, heartbeat_s=0.05)
        fleet.start()
        router = FleetRouter(caddr, poll_s=0.05)
        client = RpcClient(f"127.0.0.1:{{router.start()}}",
                           fmsg.DECODE_SERVICE, fmsg.DECODE_METHODS)
        try:
            chunks = list(client.call("SubmitStream", fmsg.DecodeRequest(
                tokens=[1, 2, 3], max_new=3), timeout=60))
            assert chunks[-1].done and not chunks[-1].error
            assert len(chunks) == 4
        finally:
            client.close()
            router.stop()
            fleet.stop()
            coordinator.stop()
        # a sharded store's discovery: the shard map of a coordinator
        # started with two more shards, and the client over its primaries
        from parameter_server_distributed_tpu_torch.replication.failover \
            import ShardMapClient
        from parameter_server_distributed_tpu_torch.worker.ps_shards \
            import ShardedPSClient, shard_owner
        coordinator = Coordinator(config.CoordinatorConfig(
            bind_address="127.0.0.1", port=0,
            ps_shards=("127.0.0.1:2", "127.0.0.1:3")))
        shard_map = ShardMapClient(f"127.0.0.1:{{coordinator.start()}}")
        try:
            assert shard_map.refresh() and len(shard_map.primaries()) == 3
            sharded = ShardedPSClient(shard_map.primaries(),
                                      shard_map=shard_map)
            assert sharded.num_shards == 3
            assert [len(p) for p in sharded._partition(
                [msgs.Tensor.from_array(f"layer{{i}}/w", store["layer0/b"])
                 for i in range(4)])] == [
                sum(shard_owner(f"layer{{i}}/w", 3) == k for i in range(4))
                for k in range(3)]
            sharded.close()
        finally:
            coordinator.stop()
        assert not any(m.split(".")[0] in ("jax", "jaxlib")
                       or m == "parameter_server_distributed_tpu"
                       or m.startswith("parameter_server_distributed_tpu.")
                       for m in sys.modules)
        print("served, trained an LM and a ResNet, ran a PS session, a "
              "round over shm, a followed version and a fleet stream")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "a fleet stream" in proc.stdout


def test_entry_points_refuse_cpu_without_a_card(monkeypatch):
    from parameter_server_distributed_tpu_torch.async_sgd.device_optimizer \
        import PallasOptimizer
    from parameter_server_distributed_tpu_torch.cli import serve_main
    from parameter_server_distributed_tpu_torch.data.synthetic import \
        synthetic_tokens
    from parameter_server_distributed_tpu_torch.models import generation
    from parameter_server_distributed_tpu_torch.models.registry import (
        get_model, get_model_and_batches)
    from parameter_server_distributed_tpu_torch.models.serving import \
        DecodeServer
    from parameter_server_distributed_tpu_torch.worker.trainer import Trainer

    from parameter_server_distributed_tpu_torch.async_sgd.device_optimizer \
        import DeviceOptimizer
    from parameter_server_distributed_tpu_torch.core.optimizer import (
        Adam, make_optimizer)
    from parameter_server_distributed_tpu_torch.obs import stats

    model = get_model("tiny_lm")
    params = model.init_params(0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PallasOptimizer("adam")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceOptimizer.adam()
    # the PS optimizer factory degrades to the host rule, counted
    fallback = stats.counter("ps.apply.device_fallback")
    before = fallback.value
    assert type(make_optimizer("pallas_adam", 1e-3)) is Adam
    assert fallback.value == before + 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_tokens(2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model_and_batches("tiny_lm", 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model_and_batches("mnist_mlp", 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("mnist_mlp").init_params(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generation.generate(model, params, [[1, 2]], 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeServer(model, params, slots=1, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main.main(["--model=tiny_lm"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main.main(["--model=tiny_lm", "--serve-port=0",
                         "--coordinator=127.0.0.1:1"])


def test_cpu_params_refused_for_another_device():
    from parameter_server_distributed_tpu_torch.device import \
        check_on_device

    with pytest.raises(ValueError, match="lies on cpu"):
        check_on_device({"w": torch.zeros(1)}, torch.device("meta"))


def test_index_less_card_matches_every_index():
    """resolve_device() gives an index-less "cuda"; tensors on the card
    report "cuda:0", and must count as on it (or the Trainer would take
    card-resident params back through the host every step)."""
    from parameter_server_distributed_tpu_torch.device import same_device

    card = torch.device("cuda")
    assert same_device(torch.device("cuda", 0), card)
    assert same_device(torch.device("cuda", 1), card)
    assert same_device(torch.device("cuda", 0), torch.device("cuda", 0))
    assert not same_device(torch.device("cuda", 1), torch.device("cuda", 0))
    assert not same_device(torch.device("cpu"), card)
