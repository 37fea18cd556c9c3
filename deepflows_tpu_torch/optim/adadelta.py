"""Adadelta (counterpart of ``deepflows_tpu/optim/adadelta.py``): running
averages of g² (``s``) and of the squared update (``delta``), the update
``sqrt(delta + eps) · g / sqrt(s + eps)`` times ``lr`` (1.0 by default),
weight decay added to the gradient.  The state is ``{"s", "delta"}``."""

from __future__ import annotations

from .optimizer import Optimizer


class Adadelta(Optimizer):
    elementwise = True

    def __init__(self, params, lr: float = 1.0, rho: float = 0.9,
                 weight_decay: float = 0.0, eps: float = 1e-6) -> None:
        super().__init__(params)
        self.lr = lr
        self.rho = rho
        self.eps = eps
        self.weight_decay = weight_decay

    def init_state(self):
        return {"s": self._zeros_like_params(), "delta": self._zeros_like_params()}

    def pure_update(self, params, grads, state, lr):
        new_params, new_s, new_d = list(params), list(state["s"]), list(state["delta"])
        for i, (p, g, s, d) in enumerate(zip(params, grads, state["s"], state["delta"])):
            if g is None:
                continue
            if self.weight_decay:
                g = g + p * self.weight_decay
            s = self.rho * s + (1 - self.rho) * g * g
            adjust = ((d + self.eps) ** 0.5) * g / (s + self.eps) ** 0.5
            new_d[i] = self.rho * d + (1 - self.rho) * adjust * adjust
            new_s[i] = s
            new_params[i] = (p - lr * adjust).to(p.dtype)
        return new_params, {"s": new_s, "delta": new_d}
