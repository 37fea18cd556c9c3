"""deepflows_tpu_torch — the PyTorch and CUDA port of ``deepflows_tpu``.

The package keeps the JAX package's module paths, public names and
state_dict layout (``(in, out)`` Linear weights, ``(1, out)`` biases), so a
checkpoint of one loads into the other (``utils.convert.load_jax_state_dict``).
It imports ``torch`` and never ``jax``.

Entry points place their tensors on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise rather than fall back.  Every
TPU kernel on a ported path is a hand-written CUDA kernel under ``csrc/``:
its wrapper launches it for a CUDA tensor and calls its plain PyTorch twin
for a CPU tensor (``ops/``).

Ported so far: the serving slice — ``models.TransformerLM`` and the
KV-cache decoder ``models.KVCacheDecoder`` in its dense, ``"int8"`` and
``"w8a8"`` modes, whose ``generate`` and ``generate_beam`` replay one
captured CUDA graph of the decode step a token (``jit.StepGraphs``) — and
the training slice — ``jit.CompiledTrainStep`` with
``optim.Adam`` (``fused=True``: ``ops.fused_adam``),
``nn.LMHeadCrossEntropy`` (``ops.fused_linear_ce``) and the flash route of
``nn.MultiheadAttention`` (``ops.flash_attention``), on
``TransformerLM.trunk()`` — and the third slice: full-bf16 weight training
(``Module.bfloat16()`` with ``optim.Adam(stochastic_round=True)``:
``ops.fused_adam_sr``) and the eager f32 route behind
``config.use_pallas`` (``nn.functional.linear``: ``ops.linear_fused`` and
``ops.matmul``), which trains ``models.MLP``; the Llama and Mixtral
family; and the CNN family — ``nn.Conv1d/2d``, ``WSConv2d``,
``BatchNorm1d/2d``, the pools, ``nn.Remat`` and ``optim.SGD``, with
ResNet18/34/50 (and the norm-free NF-ResNets), MobileNetV1/V2, VGG16,
ViT_Tiny and the reference's CNNs.  Convolution, batch norm and pooling
run on PyTorch's own ops (cuDNN on the card), as the JAX package leaves
them to XLA outside any Pallas kernel.  Then fine-tuning and the rest of
nn and optim: LoRA (``nn.apply_lora``, ``merge_lora``; the decoders
refuse an unmerged model), ``nn.GroupNorm``, ``nn.Identity`` and
``nn.fuse_conv_bn``; AdamW, Muon, Adafactor, Lion, RMSprop, Adagrad,
Adadelta, ``ModelEMA``, the schedulers and clipping by global norm;
``CompiledTrainStep``'s ``accum_steps`` and ``metrics_fn`` and the
``jit`` decorator.  Their arithmetic is plain PyTorch, as the JAX
package's is plain jnp.  Then the encoder-decoder family with the rest of
nn's surface and checkpoints, and the rest of the utils: the data
pipeline (``utils.data``, whose prefetch thread stages batches on the
card), byte-level BPE and the text datasets (``utils.text``),
``utils.Trainer``, the Hugging Face and torchvision converters and
``utils.profiling``.  Then mesh and pipeline parallelism.  Then the
reference's own API, the define-by-run tape: ``Tensor``, ``Graph``, the grad
flag (``no_grad``, ``enable_grad``, ``set_grad_enabled``; ``Module.eval()``
turns it off), ``BackendTensor`` and the device registry (``Device``,
``default_device``, ``backend_api``), with the eager f32 products of the
tape on ``ops.matmul`` under ``config.use_pallas``; the ``shim/``
directory's ``DeepFlows`` package runs the reference's scripts on the
port (``python -m deepflows_tpu_torch.shim SCRIPT``).

Then lazy mode (``lazy.enable()``, or ``DEEPFLOWS_LAZY=1`` at import):
the tape's work records into fragments that run at the first host readback,
and a repeated step replays as one captured CUDA graph
(``backend/lazy.py``).

The root names are the JAX package's: ``Tensor``, ``Graph``, the grad
contexts, ``backend_api``, ``BackendTensor``, ``Device`` (the registry's,
see ``backend/device.py``), ``default_device``, ``default_accelerator``,
``manual_seed``, ``lazy`` and the tape's ops and factories.
"""

from __future__ import annotations

from .tensor import *  # noqa: F401,F403
from .tensor import Graph, Tensor
from .autograd import (  # noqa: F401
    enable_grad,
    is_grad_enable,
    is_grad_enabled,
    no_grad,
    set_grad_enabled,
)
from .backend_selection import *  # noqa: F401,F403
from .backend_selection import BackendTensor, Device, backend_api, default_device
from .backend import default_accelerator  # noqa: F401
from .config import config  # noqa: F401
from .random import manual_seed  # noqa: F401

from . import tensor as _tensor  # noqa: E402

__all__ = list(_tensor.__all__) + [
    "BackendTensor", "Device", "backend_api", "config", "default_accelerator",
    "default_device", "enable_grad", "is_grad_enable", "is_grad_enabled", "lazy",
    "manual_seed", "no_grad", "set_grad_enabled",
]

# ---------------------------------------------------------------- lazy mode
from .backend import lazy  # noqa: E402

import os as _os  # noqa: E402

if _os.environ.get("DEEPFLOWS_LAZY", "") not in ("", "0"):
    lazy.enable()
del _os
