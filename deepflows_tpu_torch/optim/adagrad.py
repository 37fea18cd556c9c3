"""Adagrad (counterpart of ``deepflows_tpu/optim/adagrad.py``): ``s += g²``
and a step of ``lr · g / sqrt(eps + s)``, weight decay added to the
gradient.  The state is ``{"s": [...]}``."""

from __future__ import annotations

from .optimizer import Optimizer


class Adagrad(Optimizer):
    elementwise = True

    def __init__(self, params, lr: float = 1e-2, weight_decay: float = 0.0,
                 eps: float = 1e-10) -> None:
        super().__init__(params)
        self.lr = lr
        self.weight_decay = weight_decay
        self.eps = eps

    def init_state(self):
        return {"s": self._zeros_like_params()}

    def pure_update(self, params, grads, state, lr):
        new_params, new_s = list(params), list(state["s"])
        for i, (p, g, s) in enumerate(zip(params, grads, state["s"])):
            if g is None:
                continue
            if self.weight_decay:
                g = g + p * self.weight_decay
            s = new_s[i] = s + g * g
            new_params[i] = (p - lr * g / (self.eps + s) ** 0.5).to(p.dtype)
        return new_params, {"s": new_s}
