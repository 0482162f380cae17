"""One Adam step of a moe_350m cut in the JAX package and in the port, on
the CPU, from one numpy store and batch: each package's loss before and
after the step and the largest relative gradient difference, as one JSON
line.

moe_350m keeps its depth (24 layers, every 2nd FFN over 8 experts,
top-1, capacity factor 1.25), its vocabulary, its 8-row batch and the
PS's Adam at lr 1e-3; by default the width is cut to d_model 384 (6
heads), d_ff 1536 and the rows to 512 tokens, in float32.  The store is
the JAX model's init at seed 0 (``--store=port``: the port Trainer's, as
the card's moe_train draws it), the batch uniform tokens from numpy
seed 0.  Not collected by pytest: a reference run, ~4 minutes and ~16
GB at the defaults (d_model 512 at 8 x 1024 passes 21 GB in JAX).

    JAX_PLATFORMS=cpu python tests/moe_step_reference.py [--store=port]
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def cut(module, args, dtype):
    cfg = module.moe_350m(seq=args.seq, dtype=dtype).config
    return module.Transformer(dataclasses.replace(
        cfg, d_model=args.d_model, n_heads=args.d_model // 64,
        d_ff=args.d_ff, n_layers=args.layers))


def step(trainer, optimizer, store, batch):
    """(loss, gradients, loss after one optimizer step)."""
    grads, loss = trainer.compute_gradients(store, batch)
    grads = {n: np.array(g, np.float32) for n, g in grads.items()}
    after = optimizer.apply({n: v.copy() for n, v in store.items()},
                            grads)
    _, loss_after = trainer.compute_gradients(
        {n: np.asarray(v, np.float32) for n, v in after.items()}, batch)
    return float(loss), grads, float(loss_after)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d-model", type=int, default=384)
    ap.add_argument("--d-ff", type=int, default=1536)
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--store", choices=("jax", "port"), default="jax")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    from parameter_server_distributed_tpu.core.optimizer import \
        make_optimizer as ref_optimizer
    from parameter_server_distributed_tpu.models import transformer as jt
    from parameter_server_distributed_tpu.worker.trainer import \
        Trainer as RefTrainer
    from parameter_server_distributed_tpu_torch.core.optimizer import \
        make_optimizer
    from parameter_server_distributed_tpu_torch.models import transformer \
        as tt
    from parameter_server_distributed_tpu_torch.worker.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    jmodel = cut(jt, args, jnp.float32)
    pmodel = cut(tt, args, torch.float32)
    init = (jmodel.init_params(0) if args.store == "jax"
            else Trainer(pmodel, device="cpu").init_params(0))
    store = {n: np.array(v, np.float32) for n, v in init.items()}
    del init
    batch = np.random.default_rng(0).integers(
        0, jmodel.config.vocab, (args.batch, args.seq), dtype=np.int32)
    ref = step(RefTrainer(jmodel, local_devices=jax.devices()[:1]),
               ref_optimizer("adam", args.lr), store, batch)
    jax.clear_caches()
    port = step(Trainer(pmodel, device="cpu"),
                make_optimizer("adam", args.lr), store, batch)
    rel = max(float(np.abs(port[1][n] - g).max()
                    / max(float(np.abs(g).max()), 1e-30))
              for n, g in ref[1].items())
    print(json.dumps({
        "model": "moe_350m cut", "d_model": args.d_model,
        "d_ff": args.d_ff, "layers": args.layers, "batch": args.batch,
        "seq": args.seq, "lr": args.lr, "store": args.store,
        "params": sum(v.size for v in store.values()),
        "jax": {"loss": ref[0], "loss_after_step": ref[2]},
        "port": {"loss": port[0], "loss_after_step": port[2]},
        "max_rel_grad_diff": rel}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
