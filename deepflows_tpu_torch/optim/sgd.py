"""SGD with momentum, nesterov and weight decay (counterpart of
``deepflows_tpu/optim/sgd.py``): ``g += wd · p``, then ``v = m · v + g``
and a step of ``v``, or of ``g + m · v`` with nesterov.  The state is
``{"v": [...]}`` with momentum, ``{"v": None}`` without."""

from __future__ import annotations

from .optimizer import Optimizer


class SGD(Optimizer):
    def __init__(
        self,
        params,
        lr: float = 1e-2,
        momentum: float = 0.0,
        weight_decay: float = 0.0,
        nesterov: bool = False,
    ) -> None:
        super().__init__(params)
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov

    def init_state(self):
        return {"v": self._zeros_like_params() if self.momentum > 0.0 else None}

    def pure_update(self, params, grads, state, lr):
        m = self.momentum
        new_params = list(params)
        new_v = list(state["v"]) if m > 0.0 else None
        for i, (p, g) in enumerate(zip(params, grads)):
            if g is None:
                continue
            if self.weight_decay:
                g = g + p * self.weight_decay
            if m > 0.0:
                v = new_v[i] * m + g
                update = g + m * v if self.nesterov else v
                new_v[i] = v
            else:
                update = g
            new_params[i] = (p - lr * update).to(p.dtype)
        return new_params, {"v": new_v}
