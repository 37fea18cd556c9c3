"""Hugging Face Llama, Mistral and Mixtral interop (counterpart of
``deepflows_tpu/utils/hf_llama.py``): build a ``models.LlamaLM`` or
``models.MixtralLM`` from a transformers config and load its state dict.

The config is duck-typed: any object with the attribute names of HF's
``config.json`` (a ``transformers`` config, or a ``SimpleNamespace``), so
nothing here imports ``transformers``.  HF's Linear weights are ``(out,
in)`` and the port's are the reference's ``(in, out)``: every projection
is transposed.  A missing ``lm_head`` means tied embeddings.  Mistral's
``sliding_window`` becomes the model's ``window``.  The state dict's
values may be torch tensors (any float dtype, on any device) or numpy
arrays; each is widened to f32 and copied into the model's tensor on its
device, in the tensor's dtype.  A missing key raises ``KeyError``, a shape
that differs or a key left over ``ValueError``, with the JAX package's
messages.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch


def _f32(v) -> torch.Tensor:
    """A state dict value as an f32 tensor (torch tensors stay where they are)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float32)
    return torch.from_numpy(np.asarray(v, dtype=np.float32))


def _copy(param, arr, key: str) -> None:
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"{key}: shape {tuple(arr.shape)} does not fit {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(arr)


def _taker(sd):
    """``put(param, key, transpose)``: pop ``key`` from ``sd`` into ``param``."""

    def put(param, key: str, transpose: bool = False):
        if key not in sd:
            raise KeyError(f"state_dict is missing {key!r}")
        arr = _f32(sd.pop(key))
        _copy(param, arr.t() if transpose else arr, key)

    return put


def _set_eps(model, cfg):
    eps = float(getattr(cfg, "rms_norm_eps", 1e-6))
    for blk in model.blocks:
        blk.norm1.eps = eps
        blk.norm2.eps = eps
    model.norm.eps = eps


def build_llama_from_hf_config(cfg, max_len: Optional[int] = None, device=None):
    """A ``models.LlamaLM`` with the architecture of a transformers
    ``LlamaConfig`` or ``MistralConfig`` (hidden size, heads, GQA width,
    intermediate size, rope theta, RMSNorm eps, sliding window), random
    weights, on ``device`` (the card by default)."""
    from ..models.llama import LlamaLM

    if getattr(cfg, "attention_bias", False):
        raise NotImplementedError(
            "attention_bias=True Llama variants are not supported "
            "(this LlamaLM is bias-free per the Llama recipe)"
        )
    dim = cfg.hidden_size
    model = LlamaLM(
        vocab_size=cfg.vocab_size,
        max_len=int(max_len or cfg.max_position_embeddings),
        dim=dim,
        depth=cfg.num_hidden_layers,
        num_heads=cfg.num_attention_heads,
        num_kv_heads=getattr(cfg, "num_key_value_heads", None),
        mlp_ratio=cfg.intermediate_size / dim,
        rope_theta=float(getattr(cfg, "rope_theta", 10000.0)),
        device=device,
        window=getattr(cfg, "sliding_window", None),
    )
    _set_eps(model, cfg)
    return model


def _load_common(model, sd, state_dict, put, block_rest):
    put(model.tok_embed.weight, "model.embed_tokens.weight")
    for i, blk in enumerate(model.blocks):
        pre = f"model.layers.{i}."
        put(blk.norm1.weight, pre + "input_layernorm.weight")
        put(blk.attn.q_proj.weight, pre + "self_attn.q_proj.weight", True)
        put(blk.attn.k_proj.weight, pre + "self_attn.k_proj.weight", True)
        put(blk.attn.v_proj.weight, pre + "self_attn.v_proj.weight", True)
        put(blk.attn.out_proj.weight, pre + "self_attn.o_proj.weight", True)
        put(blk.norm2.weight, pre + "post_attention_layernorm.weight")
        block_rest(blk, pre)
    put(model.norm.weight, "model.norm.weight")
    if "lm_head.weight" in sd:
        put(model.head.weight, "lm_head.weight", True)
    else:  # tied embeddings: the head shares the token table
        arr = _f32(state_dict["model.embed_tokens.weight"]).t()
        if tuple(arr.shape) != tuple(model.head.weight.shape):
            raise ValueError("tied lm_head shape mismatch")
        with torch.no_grad():
            model.head.weight.copy_(arr)
    # rotary inv_freq buffers are not weights; anything else left over is
    # a weight nothing took
    leftover = [k for k in sd if not k.endswith("inv_freq")]
    if leftover:
        raise ValueError(f"unconverted state_dict entries: {leftover}")


def load_hf_llama_state(model, state_dict: Mapping) -> None:
    """Load a transformers Llama or Mistral ``state_dict`` into ``model`` (a
    ``models.LlamaLM`` of the same architecture) in place; nothing is
    skipped silently."""
    sd = dict(state_dict.items())
    put = _taker(sd)

    def mlp(blk, pre):
        put(blk.gate.weight, pre + "mlp.gate_proj.weight", True)
        put(blk.up.weight, pre + "mlp.up_proj.weight", True)
        put(blk.down.weight, pre + "mlp.down_proj.weight", True)

    _load_common(model, sd, state_dict, put, mlp)


def convert_hf_llama(hf_model, max_len: Optional[int] = None, device=None):
    """transformers ``LlamaForCausalLM`` (or Mistral) -> ``LlamaLM`` with its
    weights."""
    model = build_llama_from_hf_config(hf_model.config, max_len=max_len, device=device)
    load_hf_llama_state(model, hf_model.state_dict())
    return model


# --------------------------------------------------------------- Mixtral
def build_mixtral_from_hf_config(cfg, max_len: Optional[int] = None, device=None):
    """A ``models.MixtralLM`` of a transformers ``MixtralConfig`` (expert
    count, top-k, GQA width, intermediate size, rope theta), random
    weights, on ``device`` (the card by default)."""
    from ..models.mixtral import MixtralLM

    dim = cfg.hidden_size
    model = MixtralLM(
        vocab_size=cfg.vocab_size,
        max_len=int(max_len or cfg.max_position_embeddings),
        dim=dim,
        depth=cfg.num_hidden_layers,
        num_heads=cfg.num_attention_heads,
        num_kv_heads=getattr(cfg, "num_key_value_heads", None),
        n_experts=cfg.num_local_experts,
        top_k=cfg.num_experts_per_tok,
        mlp_ratio=cfg.intermediate_size / dim,
        rope_theta=float(getattr(cfg, "rope_theta", 10000.0)),
        device=device,
    )
    _set_eps(model, cfg)
    return model


def load_hf_mixtral_state(model, state_dict: Mapping) -> None:
    """Load a transformers Mixtral ``state_dict`` into ``model`` (a
    ``models.MixtralLM``).  Each expert's w1 / w3 / w2 (gate / up / down,
    ``(out, in)``) is transposed into the ``(E, in, out)`` stacks; HF's
    router has no bias, so the model's is zeroed.  Softmax, then top-k and
    renormalise equals HF's top-k of the logits, then softmax."""
    sd = dict(state_dict.items())
    put = _taker(sd)

    def put_stacked(param, keys):
        mats = []
        for key in keys:
            if key not in sd:
                raise KeyError(f"state_dict is missing {key!r}")
            mats.append(_f32(sd.pop(key)).t().to(param.device))
            if mats[-1].shape != mats[0].shape:
                raise ValueError(f"{key}: shape {tuple(mats[-1].shape)[::-1]} differs from "
                                 f"{keys[0]}'s {tuple(mats[0].shape)[::-1]}")
        arr = torch.stack(mats)
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(
                f"{keys[0]}...: stack {tuple(arr.shape)} does not fit {tuple(param.shape)}"
            )
        with torch.no_grad():
            param.copy_(arr)

    def moe(blk, pre):
        m, E = blk.moe, blk.moe.n_experts
        put(m.router.weight, pre + "block_sparse_moe.gate.weight", True)
        with torch.no_grad():
            m.router.bias.zero_()
        ex = pre + "block_sparse_moe.experts."
        put_stacked(m.experts_gate, [f"{ex}{j}.w1.weight" for j in range(E)])
        put_stacked(m.experts_up, [f"{ex}{j}.w3.weight" for j in range(E)])
        put_stacked(m.experts_down, [f"{ex}{j}.w2.weight" for j in range(E)])

    _load_common(model, sd, state_dict, put, moe)


def convert_hf_mixtral(hf_model, max_len: Optional[int] = None, device=None):
    """transformers ``MixtralForCausalLM`` -> ``MixtralLM`` with its weights."""
    model = build_mixtral_from_hf_config(hf_model.config, max_len=max_len, device=device)
    load_hf_mixtral_state(model, hf_model.state_dict())
    return model
