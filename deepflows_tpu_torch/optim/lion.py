"""Lion, the sign-momentum optimizer (counterpart of
``deepflows_tpu/optim/lion.py``; Chen et al. 2023):

    u  = sign(beta1 · m + (1 - beta1) · g)
    p <- p - lr · (u + weight_decay · p)
    m <- beta2 · m + (1 - beta2) · g

One f32 slot: the state is ``{"m": [...]}``."""

from __future__ import annotations

import torch

from .optimizer import Optimizer


class Lion(Optimizer):
    elementwise = True

    def __init__(self, params, lr: float = 1e-4, betas=(0.9, 0.99),
                 weight_decay: float = 0.0) -> None:
        super().__init__(params)
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.weight_decay = float(weight_decay)

    def init_state(self):
        return {"m": self._zeros_like_params()}

    def pure_update(self, params, grads, state, lr):
        new_params, new_m = list(params), list(state["m"])
        for i, (p, g, m) in enumerate(zip(params, grads, state["m"])):
            if g is None:
                continue
            gf = g.to(m.dtype)
            u = torch.sign(m * self.beta1 + gf * (1.0 - self.beta1))
            new_params[i] = (p - lr * (u + self.weight_decay * p)).to(p.dtype)
            new_m[i] = m * self.beta2 + gf * (1.0 - self.beta2)
        return new_params, {"m": new_m}
