"""Hugging Face GPT-2 interop (counterpart of ``deepflows_tpu/utils/hf_gpt2.py``):
build a ``models.TransformerLM`` from a transformers ``GPT2Config`` (or any
object with its attribute names) and load its state dict.

GPT-2 keeps its projections as Conv1D, already ``(in, out)``: nothing is
transposed but the tied head, ``wte`` transposed, whose bias is zeroed
(GPT-2's head has none).  The fused ``c_attn`` splits column-wise into q,
k and v.  GPT-2's activation is the tanh GELU, so each block's GELU is
built with ``approximate="tanh"``.  A missing key raises ``KeyError``, an
array of another size or a key left over ``ValueError``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from .hf_llama import _f32


def build_gpt2_from_hf_config(cfg, max_len: Optional[int] = None, device=None):
    """A ``models.TransformerLM`` of GPT-2's architecture, random weights,
    on ``device`` (the card by default)."""
    from .. import nn
    from ..models.transformer_lm import TransformerLM

    model = TransformerLM(
        vocab_size=cfg.vocab_size,
        max_len=int(max_len or cfg.n_positions),
        dim=cfg.n_embd,
        depth=cfg.n_layer,
        num_heads=cfg.n_head,
        mlp_ratio=(getattr(cfg, "n_inner", None) or 4 * cfg.n_embd) / cfg.n_embd,
        device=device,
    )
    eps = float(getattr(cfg, "layer_norm_epsilon", 1e-5))
    for blk in model.blocks:
        blk.mlp[1] = nn.GELU(approximate="tanh")  # gelu_new, not the exact erf
        blk.norm1.eps = eps
        blk.norm2.eps = eps
    model.norm.eps = eps
    return model


def load_hf_gpt2_state(model, state_dict: Mapping) -> None:
    """Load a transformers GPT-2 ``state_dict`` into ``model`` (a
    ``models.TransformerLM``) in place; the causal-mask buffers
    (``attn.bias``, ``attn.masked_bias``) are not weights and are ignored."""
    sd = dict(state_dict.items())

    def arr_of(key):
        if key not in sd:
            raise KeyError(f"state_dict is missing {key!r}")
        return _f32(sd.pop(key))

    def put(param, arr, key):
        if arr.numel() != param.numel():
            raise ValueError(f"{key}: shape {tuple(arr.shape)} does not fit {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(arr.reshape(param.shape))

    D = model.pos_embed.shape[2]
    put(model.tok_embed.weight, arr_of("transformer.wte.weight"), "transformer.wte.weight")
    wpe = arr_of("transformer.wpe.weight")
    if wpe.shape[0] < model.max_len:
        raise ValueError(f"wpe covers {wpe.shape[0]} positions < max_len {model.max_len}")
    put(model.pos_embed, wpe[: model.max_len][None], "transformer.wpe.weight")
    for i, blk in enumerate(model.blocks):
        pre = f"transformer.h.{i}."
        put(blk.norm1.weight, arr_of(pre + "ln_1.weight"), pre + "ln_1.weight")
        put(blk.norm1.bias, arr_of(pre + "ln_1.bias"), pre + "ln_1.bias")
        ca_w = arr_of(pre + "attn.c_attn.weight")  # (D, 3D), Conv1D layout
        ca_b = arr_of(pre + "attn.c_attn.bias")  # (3D,)
        if tuple(ca_w.shape) != (D, 3 * D):
            raise ValueError(f"{pre}attn.c_attn.weight: {tuple(ca_w.shape)}")
        a = blk.attn
        for j, (w_p, b_p) in enumerate(((a.q_proj.weight, a.q_proj.bias),
                                        (a.k_proj.weight, a.k_proj.bias),
                                        (a.v_proj.weight, a.v_proj.bias))):
            put(w_p, ca_w[:, j * D:(j + 1) * D], pre + "attn.c_attn.weight")
            put(b_p, ca_b[j * D:(j + 1) * D], pre + "attn.c_attn.bias")
        for param, key in ((a.out_proj.weight, "attn.c_proj.weight"),
                           (a.out_proj.bias, "attn.c_proj.bias"),
                           (blk.norm2.weight, "ln_2.weight"),
                           (blk.norm2.bias, "ln_2.bias"),
                           (blk.mlp[0].weight, "mlp.c_fc.weight"),
                           (blk.mlp[0].bias, "mlp.c_fc.bias"),
                           (blk.mlp[2].weight, "mlp.c_proj.weight"),
                           (blk.mlp[2].bias, "mlp.c_proj.bias")):
            put(param, arr_of(pre + key), pre + key)
    put(model.norm.weight, arr_of("transformer.ln_f.weight"), "transformer.ln_f.weight")
    put(model.norm.bias, arr_of("transformer.ln_f.bias"), "transformer.ln_f.bias")
    head = (arr_of("lm_head.weight") if "lm_head.weight" in sd
            else _f32(state_dict["transformer.wte.weight"]))
    put(model.head.weight, head.t(), "lm_head.weight")
    with torch.no_grad():
        model.head.bias.zero_()
    leftover = [k for k in sd if ".attn.bias" not in k and ".attn.masked_bias" not in k]
    if leftover:
        raise ValueError(f"unconverted state_dict entries: {leftover}")


def convert_hf_gpt2(hf_model, max_len: Optional[int] = None, device=None):
    """transformers ``GPT2LMHeadModel`` -> ``TransformerLM`` with its weights."""
    model = build_gpt2_from_hf_config(hf_model.config, max_len=max_len, device=device)
    load_hf_gpt2_state(model, hf_model.state_dict())
    return model
