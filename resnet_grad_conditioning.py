"""How far apart two correct evaluations of a ResNet row's gradients lie,
on one NVIDIA card and its host.

    python3 resnet_grad_conditioning.py

For resnet18_cifar (float32) and resnet50_imagenet (float32 and its
bf16), on a 4-image slice of the row's synthetic batch, it takes the
gradients of the port's ``Trainer`` on the CPU (the default thread count
and one thread), on the card (cuDNN, TF32 off) and on the card without
cuDNN, and, for the float32 rows, a float64 evaluation of the same
network (a plain forward in this file: ``F.conv2d`` with the port's SAME
padding, batch-statistics norms, the max pool and the head).  Each pair
is reported as the largest error over the reference's gradient
allowance (rtol 5e-4, atol 1e-5) and as the largest error over each
gradient's largest entry, the worst tensor named.  resnet18_cifar runs
from two stores, seeded on the card and on the CPU.  One JSON line a
case; needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def distance(np, got: dict, want: dict) -> dict:
    """The largest error over the rtol 5e-4, atol 1e-5 allowance, and
    over each gradient's largest entry, with the worst tensors."""
    strict, by_max = {}, {}
    for name, ref in want.items():
        diff = np.abs(np.asarray(got[name], np.float64) - ref)
        strict[name] = float((diff / (1e-5 + 5e-4 * np.abs(ref))).max())
        by_max[name] = float(diff.max() / max(np.abs(ref).max(), 1e-30))
    worst = max(strict, key=strict.get)
    return {"over_allowance": strict[worst], "tensor": worst,
            "over_largest": max(by_max.values()),
            "tensor_largest": max(by_max, key=by_max.get)}


def f64_grads(torch, model, store: dict, x, y) -> tuple[dict, float]:
    """Loss and gradients of ``model``'s network in float64 on the CPU:
    the same convs, pads, norms, pool and head, every value float64."""
    import torch.nn.functional as F

    from parameter_server_distributed_tpu_torch.models import resnet

    def pad(h, k, stride, value=0.0):
        t, b = resnet.same_pads(h.shape[2], k, stride)
        left, right = resnet.same_pads(h.shape[3], k, stride)
        return F.pad(h, (left, right, t, b), value=value)

    def conv(h, w, stride=1):
        return F.conv2d(pad(h, w.shape[0], stride), w.permute(3, 2, 0, 1),
                        stride=stride)

    def norm(h, scale, bias, eps=1e-5):
        mean = h.mean(dim=(0, 2, 3), keepdim=True)
        var = (h - mean).square().mean(dim=(0, 2, 3), keepdim=True)
        return ((h - mean) * torch.rsqrt(var + eps) * scale[:, None, None]
                + bias[:, None, None])

    c = model.config
    p = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
         for k, v in store.items()}
    h = conv(torch.as_tensor(x, dtype=torch.float64).permute(0, 3, 1, 2),
             p["stem/conv/w"], 1 if c.small_inputs else 2)
    h = F.relu(norm(h, p["stem/norm/scale"], p["stem/norm/bias"]))
    if not c.small_inputs:
        h = F.max_pool2d(pad(h, 3, 2, -math.inf), 3, 2)
    for prefix, _in, _base, stride, proj in model._block_names():
        convs = (("conv1", 1), ("conv2", stride), ("conv3", 1)) \
            if c.bottleneck else (("conv1", stride), ("conv2", 1))
        out = h
        for i, (name, s) in enumerate(convs, 1):
            out = norm(conv(out, p[f"{prefix}/{name}/w"], s),
                       p[f"{prefix}/norm{i}/scale"],
                       p[f"{prefix}/norm{i}/bias"])
            if i < len(convs):
                out = F.relu(out)
        short = h
        if proj:
            short = norm(conv(h, p[f"{prefix}/proj/w"], stride),
                         p[f"{prefix}/proj_norm/scale"],
                         p[f"{prefix}/proj_norm/bias"])
        h = F.relu(out + short)
    logits = h.mean(dim=(2, 3)) @ p["head/w"] + p["head/b"]
    logp = F.log_softmax(logits, dim=-1)
    loss = -logp.gather(-1, torch.as_tensor(y).long()[:, None]).mean()
    grads = torch.autograd.grad(loss, list(p.values()))
    return ({k: g.numpy() for k, g in zip(p, grads)}, float(loss.detach()))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("resnet_grad_conditioning.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, HERE)
    from parameter_server_distributed_tpu_torch.models.registry import \
        get_model_and_batches
    from parameter_server_distributed_tpu_torch.worker.trainer import Trainer

    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "torch": torch.__version__}),
          flush=True)
    threads = torch.get_num_threads()
    t0 = time.perf_counter()
    cases = (("resnet18_cifar", "", 256, ("cuda", "cpu")),
             ("resnet50_imagenet", "f32", 16, ("cuda",)),
             ("resnet50_imagenet", "", 16, ("cuda",)))
    for name, dtype, batch, seeds in cases:
        model, batches = get_model_and_batches(name, batch, seed=0,
                                               dtype=dtype, device="cpu")
        x, y = next(batches)
        x, y = x[:4], y[:4]
        del batches
        for seed_on in seeds:
            store = Trainer(model, device=seed_on).init_params(0)
            grads = {}
            torch.set_num_threads(threads)
            grads["cpu"], loss_cpu = Trainer(model, device="cpu") \
                .compute_gradients(store, (x, y))
            torch.set_num_threads(1)
            grads["cpu_1_thread"], _ = Trainer(model, device="cpu") \
                .compute_gradients(store, (x, y))
            torch.set_num_threads(threads)
            grads["card"], loss_card = Trainer(model).compute_gradients(
                store, (x.cuda(), y.cuda()))
            torch.backends.cudnn.enabled = False
            try:
                grads["card_no_cudnn"], _ = Trainer(model) \
                    .compute_gradients(store, (x.cuda(), y.cuda()))
            finally:
                torch.backends.cudnn.enabled = True
            out = {"row": name, "dtype": str(model.config.dtype)[6:],
                   "store_seeded_on": seed_on, "images": 4,
                   "loss": {"cpu": loss_cpu, "card": loss_card},
                   "cpu_1_thread_vs_cpu": distance(
                       np, grads["cpu_1_thread"], grads["cpu"]),
                   "card_vs_cpu": distance(np, grads["card"], grads["cpu"])}
            if model.config.dtype == torch.float32:
                exact, out["loss"]["f64"] = f64_grads(torch, model, store,
                                                      x.numpy(), y.numpy())
                for key in ("cpu", "card", "card_no_cudnn"):
                    out[f"{key}_vs_f64"] = distance(np, grads[key], exact)
            out["elapsed_s"] = time.perf_counter() - t0
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
