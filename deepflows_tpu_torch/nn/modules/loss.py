"""Loss modules of the training slice (counterpart of ``CrossEntropyLoss``
and ``LMHeadCrossEntropy`` in ``deepflows_tpu/nn/modules/loss.py``; the
other losses come with later slices)."""

from __future__ import annotations

from ...ops.fused_ce import fused_linear_ce
from .. import functional as F
from .module import Module


class _Loss(Module):
    def __init__(self, reduction: str = "mean") -> None:
        super().__init__()
        if reduction not in ("mean", "sum", "none"):
            raise ValueError("reduction must be 'mean', 'sum' or 'none'")
        self.reduction = reduction


class CrossEntropyLoss(_Loss):
    """``F.cross_entropy`` as a module: integer or one-hot targets,
    ``(B, L, V)`` logits, ``ignore_index`` and ``label_smoothing``."""

    def __init__(self, reduction: str = "mean", ignore_index=None,
                 label_smoothing: float = 0.0) -> None:
        super().__init__(reduction)
        self.ignore_index = ignore_index
        self.label_smoothing = float(label_smoothing)

    def forward(self, input, target):
        return F.cross_entropy(
            input, target, reduction=self.reduction,
            ignore_index=self.ignore_index, label_smoothing=self.label_smoothing,
        )


class LMHeadCrossEntropy(_Loss):
    """Fused LM head and token cross-entropy.  Pair it with a model that
    outputs hidden states (``TransformerLM.trunk()``) and pass that model's
    own ``head`` Linear: the head product and the cross-entropy run as one
    kernel (``ops.fused_linear_ce``) that never stores the (B·L, vocab)
    logits, forward or backward.

    The head stays a reference, not a child: it belongs to the model, so
    the optimizer and checkpoints see it as usual, and a train step that
    rebinds the model's parameters (``jit.CompiledTrainStep`` with a
    ``compute_dtype``) rebinds the head's here too.  The (1, V) bias goes
    in reshaped to (V,)."""

    def __init__(self, head, reduction: str = "mean"):
        super().__init__(reduction)
        object.__setattr__(self, "_head", head)

    def forward(self, hidden, target):
        x = hidden.reshape(-1, hidden.shape[-1])
        t = target.reshape(-1)
        head = self._head
        loss = fused_linear_ce(x, head.weight, head.bias.reshape(-1), t)
        if self.reduction == "mean":
            return loss.mean()
        if self.reduction == "sum":
            return loss.sum()
        return loss
