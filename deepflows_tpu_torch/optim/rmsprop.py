"""RMSprop (counterpart of ``deepflows_tpu/optim/rmsprop.py``;
``torch.optim.RMSprop``'s semantics): weight decay added to the gradient,
``eps`` outside the square root, optional momentum and centering.  The
state is ``{"square_avg"}``, with ``"momentum_buf"`` when ``momentum`` and
``"grad_avg"`` when ``centered``."""

from __future__ import annotations

from .optimizer import Optimizer


class RMSprop(Optimizer):
    elementwise = True

    def __init__(
        self,
        params,
        lr: float = 1e-2,
        alpha: float = 0.99,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        momentum: float = 0.0,
        centered: bool = False,
    ) -> None:
        super().__init__(params)
        self.lr = lr
        self.alpha = alpha
        self.eps = eps
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.centered = centered

    def init_state(self):
        state = {"square_avg": self._zeros_like_params()}
        if self.momentum:
            state["momentum_buf"] = self._zeros_like_params()
        if self.centered:
            state["grad_avg"] = self._zeros_like_params()
        return state

    def pure_update(self, params, grads, state, lr):
        a = self.alpha
        new = {k: list(v) for k, v in state.items()}
        new_params = list(params)
        for i, (p, g) in enumerate(zip(params, grads)):
            if g is None:
                continue
            if self.weight_decay:
                g = g + p * self.weight_decay
            s = new["square_avg"][i] = new["square_avg"][i] * a + g * g * (1.0 - a)
            if self.centered:
                ga = new["grad_avg"][i] = new["grad_avg"][i] * a + g * (1.0 - a)
                denom = (s - ga * ga) ** 0.5 + self.eps
            else:
                denom = s**0.5 + self.eps
            if self.momentum:
                m = new["momentum_buf"][i] = new["momentum_buf"][i] * self.momentum + g / denom
                step = m * lr
            else:
                step = g / denom * lr
            new_params[i] = (p - step).to(p.dtype)
        return new_params, new
