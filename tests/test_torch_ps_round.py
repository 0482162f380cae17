"""One whole synchronous parameter-server round through each package:
a coordinator registers two workers, a PS core closes each barrier over
their pushes through the fused Adam update, and each worker serves
itself the fresh store, steps ``small_lm`` (f32, flash attention) on its
own batch (the first of its registry stream, seeded with its id) and
pushes — two rounds, the workers one after the other.
The JAX side runs its Trainer and core (the Pallas kernels in interpret
mode, as tests/test_torch_trainer.py runs them), the port its Trainer
and core on the CPU (the kernels' plain versions).  Both start from the
JAX init, converted to numpy.

The round runs once with the fused momentum update and once with the
fused Adam update (the card round's).  Tolerances: every loss within
1e-5 relative, the params after each round at rtol 1e-4, atol 1e-6
(tests/test_pallas_ops.py:152).  With momentum every entry holds them.
Adam runs at eps 1e-6, as test_torch_trainer.py's loop does, and still
hands the two frameworks' gradient rounding to a few entries almost
undamped: an entry whose mean gradient is near eps in size moves by about
lr * g / (|g| + eps), so a rounding difference that is a share of g moves
the update by that share of lr.  With these seeds 13 to 14 of
the 656,000 entries (in embed/tok, layer0's wo, wq, w1 and w2, layer1's
w2) leave the tolerance each round, by at most 1.3e-5 (0.013 lr).  So with
Adam every entry of a store but at most 15 holds the tolerance, and those
few are within 0.1 lr."""

import jax
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu.async_sgd.device_optimizer import \
    PallasOptimizer as JaxPallas
from parameter_server_distributed_tpu.core.coordinator_core import \
    CoordinatorCore as JaxCoordinator
from parameter_server_distributed_tpu.core.ps_core import \
    ParameterServerCore as JaxCore
from parameter_server_distributed_tpu.models import registry as jax_registry
from parameter_server_distributed_tpu.worker.trainer import \
    Trainer as JaxTrainer
from parameter_server_distributed_tpu_torch.async_sgd.device_optimizer \
    import PallasOptimizer
from parameter_server_distributed_tpu_torch.core.coordinator_core import \
    CoordinatorCore
from parameter_server_distributed_tpu_torch.core.ps_core import \
    ParameterServerCore
from parameter_server_distributed_tpu_torch.models import registry
from parameter_server_distributed_tpu_torch.worker.trainer import Trainer


@pytest.fixture(autouse=True)
def hygiene():
    """torch on at most two intra-op threads: these tests' products are
    small, and more threads only cost time where workers share cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        yield
    finally:
        torch.set_num_threads(threads)


WORKERS, ROUNDS, BATCH = 2, 2, 2
RULES = {"momentum": dict(learning_rate=1e-2, momentum=0.9),
         "adam": dict(learning_rate=1e-3, eps=1e-6)}
TOL = dict(rtol=1e-4, atol=1e-6)
ADAM_NEAR_EPS_ENTRIES = 15   # entries of a store allowed outside TOL


def run_round(coord_cls, core_cls, optimizer, trainers, batches, init):
    """The round as an in-process caller drives it: register, initialise,
    then per round and worker serve -> step -> push.  Returns the losses
    and the params (as numpy) after each round."""
    coord = coord_cls("127.0.0.1", 50051)
    for wid in range(WORKERS):
        coord.register_worker(wid, "127.0.0.1", 6000 + wid, f"w{wid}")
    ps = core_cls(total_workers=WORKERS, optimizer=optimizer,
                  live_workers_fn=coord.width_provider())
    ps.initialize_parameters(init)
    losses, stores = [], []
    for it in range(1, ROUNDS + 1):
        for wid in range(WORKERS):
            _, params, ready = ps.serve_parameters(it)
            assert ready
            grads, loss = trainers[wid].compute_gradients(params,
                                                          batches[wid])
            result = ps.receive_gradients(wid, it, grads)
            assert result.success
            assert result.aggregation_complete == (wid == WORKERS - 1)
            losses.append(loss)
        assert ps.check_sync_status(it)[1:] == (True, WORKERS, WORKERS)
        stores.append({k: (v.numpy() if isinstance(v, torch.Tensor)
                           else np.asarray(v))
                       for k, v in ps.get_parameters().items()})
    return losses, stores, ps


@pytest.fixture
def flash_default(monkeypatch):
    """The registries' models with flash attention as their default."""
    monkeypatch.setenv("PSDT_FLASH_ATTENTION", "1")


def assert_params(got, ref, rule, lr):
    off = 0
    for k in ref:
        if rule == "momentum":
            np.testing.assert_allclose(got[k], ref[k], **TOL, err_msg=k)
            continue
        off += int((~np.isclose(got[k], ref[k], **TOL)).sum())
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=0.1 * lr,
                                   err_msg=k)
    assert off <= ADAM_NEAR_EPS_ENTRIES, off


@pytest.mark.parametrize("rule", list(RULES))
def test_round_matches_jax(flash_default, rule):
    jax_side = [jax_registry.get_model_and_batches("small_lm", BATCH,
                                                   seed=wid)
                for wid in range(WORKERS)]
    port_side = [registry.get_model_and_batches("small_lm", BATCH, seed=wid,
                                                device="cpu")
                 for wid in range(WORKERS)]
    init = {k: np.array(v, np.float32)
            for k, v in jax_side[0][0].init_params(0).items()}
    ref_losses, ref_stores, _ = run_round(
        JaxCoordinator, JaxCore, JaxPallas(rule, **RULES[rule]),
        [JaxTrainer(m, local_devices=jax.devices()[:1]) for m, _ in jax_side],
        [next(b) for _, b in jax_side], init)
    losses, stores, ps = run_round(
        CoordinatorCore, ParameterServerCore,
        PallasOptimizer(rule, device="cpu", **RULES[rule]),
        [Trainer(m, device="cpu") for m, _ in port_side],
        [next(b) for _, b in port_side], init)
    assert all(isinstance(v, torch.Tensor)
               for v in ps.serve_parameters()[1].values())
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5, atol=0)
    assert np.mean(losses[-WORKERS:]) < np.mean(losses[:WORKERS])
    for got, ref in zip(stores, ref_stores):
        assert sorted(got) == sorted(ref)
        assert_params(got, ref, rule, RULES[rule]["learning_rate"])
