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
            finally:
                server.stop()
        assert not any(m.split(".")[0] in ("jax", "jaxlib")
                       or m == "parameter_server_distributed_tpu"
                       or m.startswith("parameter_server_distributed_tpu.")
                       for m in sys.modules)
        print("served, trained, ran a PS session and a round over shm")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "a round over shm" in proc.stdout


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
