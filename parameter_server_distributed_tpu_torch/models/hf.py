"""Hugging Face interop in PyTorch: the port of
parameter_server_distributed_tpu/models/hf.py.  GPT-2 and LLaMA stores
convert into the port's Transformer and back.

A converter takes any object with ``.config`` and ``.state_dict()`` (a
``transformers`` model, or a plain stand-in holding the same names), so
this module never imports ``transformers``: a store converts on a host
that does not have it.  The state dict's values may be torch tensors or
numpy arrays.

- GPT-2 needs the three compatibility knobs of TransformerConfig
  (``pos_emb="learned"``, ``norm="layernorm"``, ``bias=True``).  HF's
  ``Conv1D`` stores weights [in, out], this package's ``x @ W`` layout,
  so matrices copy through; the fused ``c_attn`` [d, 3d] splits into
  wq/wk/wv columns; ``wte`` is tied to the LM head (``lm_head/w =
  wte.T``); HF ``gelu_new`` is the tanh-approximate GELU the model
  applies; LayerNorm eps comes from ``layer_norm_epsilon``.
- LLaMA is the native architecture (rotate-half RoPE, RMSNorm, GQA, no
  biases) with the SwiGLU MLP: ``nn.Linear`` stores [out, in], so every
  projection transposes; gate_proj -> mlp/w1, up_proj -> mlp/w3,
  down_proj -> mlp/w2.

Values go through float32 on the host and are cast once to the target
dtype (round to nearest even), as the reference's ``jnp.asarray(x,
dtype)`` does, so both packages convert a checkpoint to the same bits.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..device import resolve_device
from .quant import QTensor
from .transformer import Transformer, TransformerConfig


def _host_f32(value) -> np.ndarray:
    """A tensor (any dtype, any device) or array as host float32 numpy;
    bf16 tensors have no ``.numpy()``, so they upcast first."""
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()
    return np.asarray(value, np.float32)


def _state_dict_np(hf_model: Any) -> dict[str, np.ndarray]:
    return {name: _host_f32(t) for name, t in hf_model.state_dict().items()}


def config_from_hf_gpt2(hf_config: Any, *, dtype=torch.float32,
                        scan_layers: bool = False) -> TransformerConfig:
    """Map a ``GPT2Config`` onto TransformerConfig.  Refuses what the
    model would get silently wrong: only the tanh-approximate GELU family
    is supported, and neither attention-scaling variant; ``n_inner`` is
    honoured when set."""
    act = getattr(hf_config, "activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(
            f"unsupported activation_function {act!r}: this framework "
            "applies the tanh-approximate GELU, which matches HF "
            "'gelu_new'/'gelu_pytorch_tanh' only")
    for variant in ("scale_attn_by_inverse_layer_idx",
                    "reorder_and_upcast_attn"):
        if getattr(hf_config, variant, False):
            raise ValueError(
                f"unsupported GPT2Config.{variant}=True: this framework "
                "scales attention scores by 1/sqrt(head_dim) only — "
                "converting would produce silently wrong logits")
    n_inner = getattr(hf_config, "n_inner", None)
    return TransformerConfig(
        vocab=hf_config.vocab_size,
        d_model=hf_config.n_embd,
        n_heads=hf_config.n_head,
        n_layers=hf_config.n_layer,
        d_ff=n_inner if n_inner else 4 * hf_config.n_embd,
        max_seq=hf_config.n_positions,
        dtype=dtype,
        pos_emb="learned",
        norm="layernorm",
        bias=True,
        norm_eps=float(hf_config.layer_norm_epsilon),
        scan_layers=scan_layers,
    )


def _assemble(model: Transformer, top: dict[str, np.ndarray],
              per_layer: list[dict[str, np.ndarray]],
              device) -> dict[str, torch.Tensor]:
    """The converted store in the model's layout, name order and dtype on
    ``device``, checked against the model's shapes."""
    cfg = model.config
    dev = resolve_device(device)
    arrays = dict(top)
    if cfg.scan_layers:
        for suffix in per_layer[0]:
            arrays[f"blocks/{suffix}"] = np.stack(
                [layer[suffix] for layer in per_layer])
    else:
        for i, layer in enumerate(per_layer):
            for suffix, value in layer.items():
                arrays[f"layer{i}/{suffix}"] = value
    params = {name: torch.from_numpy(np.ascontiguousarray(value, np.float32))
              .to(device=dev, dtype=cfg.dtype)
              for name, value in arrays.items()}
    _check_shapes(model, params)
    return {name: params[name] for name in model.param_shapes()}


def from_hf_gpt2(hf_model: Any, *, dtype=torch.float32,
                 scan_layers: bool = False, device=None,
                 ) -> tuple[Transformer, dict[str, torch.Tensor]]:
    """Convert a ``GPT2LMHeadModel`` (or any object with its ``.config``
    and ``.state_dict()`` names) into (Transformer, params on ``device``,
    default the card).  A pure weight re-layout, so logits match the
    torch forward to float tolerance."""
    cfg = config_from_hf_gpt2(hf_model.config, dtype=dtype,
                              scan_layers=scan_layers)
    model = Transformer(cfg)
    sd = _state_dict_np(hf_model)
    d = cfg.d_model
    top = {
        "embed/tok": sd["transformer.wte.weight"],
        "embed/pos": sd["transformer.wpe.weight"],
        "final_ln/scale": sd["transformer.ln_f.weight"],
        "final_ln/bias": sd["transformer.ln_f.bias"],
        # weight tying: the LM head is wte transposed
        "lm_head/w": sd["transformer.wte.weight"].T,
    }
    per_layer = []
    for i in range(cfg.n_layers):
        hf = f"transformer.h.{i}"
        w_attn = sd[f"{hf}.attn.c_attn.weight"]      # [d, 3d], x @ W
        b_attn = sd[f"{hf}.attn.c_attn.bias"]        # [3d]
        per_layer.append({
            "ln1/scale": sd[f"{hf}.ln_1.weight"],
            "ln1/bias": sd[f"{hf}.ln_1.bias"],
            "attn/wq": w_attn[:, :d],
            "attn/wk": w_attn[:, d:2 * d],
            "attn/wv": w_attn[:, 2 * d:],
            "attn/bq": b_attn[:d],
            "attn/bk": b_attn[d:2 * d],
            "attn/bv": b_attn[2 * d:],
            "attn/wo": sd[f"{hf}.attn.c_proj.weight"],
            "attn/bo": sd[f"{hf}.attn.c_proj.bias"],
            "ln2/scale": sd[f"{hf}.ln_2.weight"],
            "ln2/bias": sd[f"{hf}.ln_2.bias"],
            "mlp/w1": sd[f"{hf}.mlp.c_fc.weight"],
            "mlp/b1": sd[f"{hf}.mlp.c_fc.bias"],
            "mlp/w2": sd[f"{hf}.mlp.c_proj.weight"],
            "mlp/b2": sd[f"{hf}.mlp.c_proj.bias"],
        })
    return model, _assemble(model, top, per_layer, device)


def _check_shapes(model: Transformer, params: Mapping) -> None:
    """Shape contract: exactly the parameters the config says exist."""
    expected = model.param_shapes()
    got = {name: tuple(v.shape) for name, v in params.items()}
    if got != expected:
        missing = expected.keys() - got.keys()
        extra = got.keys() - expected.keys()
        wrong = {n for n in expected.keys() & got.keys()
                 if expected[n] != got[n]}
        raise ValueError(
            f"converted store mismatch: missing={sorted(missing)} "
            f"extra={sorted(extra)} wrong_shape={sorted(wrong)}")


def _require_dense(params: Mapping[str, Any]) -> None:
    if any(isinstance(v, QTensor) for v in params.values()):
        raise ValueError("cannot export an int8-quantized store; export "
                         "the pre-quantization parameters")


def _layer_view(params: Mapping[str, Any], i: int) -> dict[str, np.ndarray]:
    """Per-layer suffix -> host float32 array, for either layer layout."""
    if any(name.startswith("blocks/") for name in params):
        return {name[len("blocks/"):]: _host_f32(v[i])
                for name, v in params.items() if name.startswith("blocks/")}
    prefix = f"layer{i}/"
    return {name[len(prefix):]: _host_f32(v)
            for name, v in params.items() if name.startswith(prefix)}


def _t(x) -> torch.Tensor:
    """A fresh, writable float32 CPU tensor (a state dict's values)."""
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def _tied(params: Mapping[str, Any]) -> bool:
    head = _host_f32(params["lm_head/w"])
    tok = _host_f32(params["embed/tok"])
    return bool(np.allclose(head, tok.T, rtol=1e-4, atol=1e-5))


def to_hf_gpt2(model: Transformer, params: Mapping[str, Any]) -> dict:
    """Export a GPT-2-architecture store to a ``GPT2LMHeadModel``
    state_dict of float32 CPU tensors: the round trip of
    :func:`from_hf_gpt2`.  GPT-2's LM head is wte: a store whose head
    has left ``embed/tok.T`` (fine-tuning here unties them) is refused,
    not silently dropped."""
    _require_dense(params)
    cfg = model.config
    if (cfg.pos_emb, cfg.norm, cfg.bias) != ("learned", "layernorm", True):
        raise ValueError("to_hf_gpt2 exports the GPT-2 architecture "
                         "(pos_emb='learned', norm='layernorm', bias=True)")
    if not _tied(params):
        raise ValueError(
            "GPT-2 ties lm_head to wte but this store's lm_head/w has "
            "diverged from embed/tok.T (fine-tuning here unties them); "
            "re-tie (params['lm_head/w'] = params['embed/tok'].T) or "
            "export a LLaMA-architecture model, whose head is untied")
    sd = {
        "transformer.wte.weight": _t(_host_f32(params["embed/tok"])),
        "transformer.wpe.weight": _t(_host_f32(params["embed/pos"])),
        "transformer.ln_f.weight": _t(_host_f32(params["final_ln/scale"])),
        "transformer.ln_f.bias": _t(_host_f32(params["final_ln/bias"])),
        "lm_head.weight": _t(_host_f32(params["embed/tok"])),    # tied
    }
    for i in range(cfg.n_layers):
        layer = _layer_view(params, i)
        hf = f"transformer.h.{i}"
        sd[f"{hf}.ln_1.weight"] = _t(layer["ln1/scale"])
        sd[f"{hf}.ln_1.bias"] = _t(layer["ln1/bias"])
        sd[f"{hf}.attn.c_attn.weight"] = _t(np.concatenate(
            [layer["attn/wq"], layer["attn/wk"], layer["attn/wv"]], axis=1))
        sd[f"{hf}.attn.c_attn.bias"] = _t(np.concatenate(
            [layer["attn/bq"], layer["attn/bk"], layer["attn/bv"]]))
        sd[f"{hf}.attn.c_proj.weight"] = _t(layer["attn/wo"])
        sd[f"{hf}.attn.c_proj.bias"] = _t(layer["attn/bo"])
        sd[f"{hf}.ln_2.weight"] = _t(layer["ln2/scale"])
        sd[f"{hf}.ln_2.bias"] = _t(layer["ln2/bias"])
        sd[f"{hf}.mlp.c_fc.weight"] = _t(layer["mlp/w1"])
        sd[f"{hf}.mlp.c_fc.bias"] = _t(layer["mlp/b1"])
        sd[f"{hf}.mlp.c_proj.weight"] = _t(layer["mlp/w2"])
        sd[f"{hf}.mlp.c_proj.bias"] = _t(layer["mlp/b2"])
    return sd


def to_hf_llama(model: Transformer, params: Mapping[str, Any], *,
                tie_word_embeddings: bool = False) -> dict:
    """Export a LLaMA-architecture store to a ``LlamaForCausalLM``
    state_dict of float32 CPU tensors: the round trip of
    :func:`from_hf_llama` (``nn.Linear`` stores [out, in]: transposed
    back).  ``tie_word_embeddings=True`` is for a destination that ties
    lm_head to embed_tokens: the export checks the tie still holds and
    omits the lm_head key, which would otherwise overwrite the shared
    embedding on load."""
    _require_dense(params)
    cfg = model.config
    if (cfg.pos_emb, cfg.norm, cfg.bias, cfg.mlp_act) != (
            "rope", "rms", False, "swiglu"):
        raise ValueError("to_hf_llama exports the LLaMA architecture "
                         "(rope/rms/bias-free/swiglu)")
    sd = {
        "model.embed_tokens.weight": _t(_host_f32(params["embed/tok"])),
        "model.norm.weight": _t(_host_f32(params["final_ln/scale"])),
    }
    if tie_word_embeddings:
        if not _tied(params):
            raise ValueError(
                "tie_word_embeddings=True but this store's lm_head/w has "
                "diverged from embed/tok.T (fine-tuning unties them); "
                "re-tie or export for an untied destination model")
    else:
        sd["lm_head.weight"] = _t(_host_f32(params["lm_head/w"]).T)
    for i in range(cfg.n_layers):
        layer = _layer_view(params, i)
        hf = f"model.layers.{i}"
        sd[f"{hf}.input_layernorm.weight"] = _t(layer["ln1/scale"])
        sd[f"{hf}.self_attn.q_proj.weight"] = _t(layer["attn/wq"].T)
        sd[f"{hf}.self_attn.k_proj.weight"] = _t(layer["attn/wk"].T)
        sd[f"{hf}.self_attn.v_proj.weight"] = _t(layer["attn/wv"].T)
        sd[f"{hf}.self_attn.o_proj.weight"] = _t(layer["attn/wo"].T)
        sd[f"{hf}.post_attention_layernorm.weight"] = _t(layer["ln2/scale"])
        sd[f"{hf}.mlp.gate_proj.weight"] = _t(layer["mlp/w1"].T)
        sd[f"{hf}.mlp.up_proj.weight"] = _t(layer["mlp/w3"].T)
        sd[f"{hf}.mlp.down_proj.weight"] = _t(layer["mlp/w2"].T)
    return sd


def config_from_hf_llama(hf_config: Any, *, dtype=torch.bfloat16,
                         scan_layers: bool = False) -> TransformerConfig:
    """Map a ``LlamaConfig`` onto TransformerConfig (a direct mapping:
    the native architecture plus the SwiGLU knob).  Refuses rope_scaling,
    attention bias and any activation but silu, whose math the model
    does not implement."""
    if getattr(hf_config, "rope_scaling", None):
        raise ValueError("unsupported rope_scaling: this framework "
                         "implements plain RoPE only")
    if getattr(hf_config, "attention_bias", False):
        raise ValueError("unsupported attention_bias=True for the "
                         "LLaMA-family conversion (bias-free attention)")
    act = getattr(hf_config, "hidden_act", "silu")
    if act != "silu":
        raise ValueError(f"unsupported hidden_act {act!r}: the SwiGLU "
                         "path applies silu gating only")
    return TransformerConfig(
        vocab=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=(hf_config.num_key_value_heads
                    if hf_config.num_key_value_heads
                    != hf_config.num_attention_heads else 0),
        n_layers=hf_config.num_hidden_layers,
        d_ff=hf_config.intermediate_size,
        max_seq=hf_config.max_position_embeddings,
        dtype=dtype,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        norm_eps=float(hf_config.rms_norm_eps),
        mlp_act="swiglu",
        scan_layers=scan_layers,
    )


def from_hf_llama(hf_model: Any, *, dtype=torch.bfloat16,
                  scan_layers: bool = False, device=None,
                  ) -> tuple[Transformer, dict[str, torch.Tensor]]:
    """Convert a ``LlamaForCausalLM`` (or any object with its
    ``.config`` and ``.state_dict()`` names) into (Transformer, params
    on ``device``, default the card).  RoPE conventions agree
    (rotate-half), so no head permutation is needed; a tied model (no
    ``lm_head.weight``) takes its head from the embedding."""
    cfg = config_from_hf_llama(hf_model.config, dtype=dtype,
                               scan_layers=scan_layers)
    model = Transformer(cfg)
    sd = _state_dict_np(hf_model)
    embed = sd["model.embed_tokens.weight"]
    top = {
        "embed/tok": embed,
        "final_ln/scale": sd["model.norm.weight"],
        "lm_head/w": (sd["lm_head.weight"].T if "lm_head.weight" in sd
                      else embed.T),
    }
    per_layer = []
    for i in range(cfg.n_layers):
        hf = f"model.layers.{i}"
        per_layer.append({
            "ln1/scale": sd[f"{hf}.input_layernorm.weight"],
            "attn/wq": sd[f"{hf}.self_attn.q_proj.weight"].T,
            "attn/wk": sd[f"{hf}.self_attn.k_proj.weight"].T,
            "attn/wv": sd[f"{hf}.self_attn.v_proj.weight"].T,
            "attn/wo": sd[f"{hf}.self_attn.o_proj.weight"].T,
            "ln2/scale": sd[f"{hf}.post_attention_layernorm.weight"],
            "mlp/w1": sd[f"{hf}.mlp.gate_proj.weight"].T,
            "mlp/w3": sd[f"{hf}.mlp.up_proj.weight"].T,
            "mlp/w2": sd[f"{hf}.mlp.down_proj.weight"].T,
        })
    return model, _assemble(model, top, per_layer, device)
