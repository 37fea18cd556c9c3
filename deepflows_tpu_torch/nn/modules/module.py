"""nn.Module (counterpart of ``deepflows_tpu/nn/modules/module.py``).

A thin layer over ``torch.nn.Module``: registration, traversal,
``state_dict`` and ``train``/``eval`` are torch's own, and the key names
they produce are the JAX package's (``blocks.0.attn.q_proj.weight``).
Unlike the JAX package, ``eval()`` does not switch gradient recording off
globally; inference code runs under ``torch.no_grad`` or
``torch.inference_mode`` itself.
"""

from __future__ import annotations

import torch


class Module(torch.nn.Module):
    """Base class of the port's modules."""
