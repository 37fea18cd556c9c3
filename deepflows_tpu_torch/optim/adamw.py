"""AdamW, Adam with decoupled weight decay (counterpart of
``deepflows_tpu/optim/adamw.py``; ``torch.optim.AdamW``'s semantics): the
parameter is multiplied by ``1 - lr · wd`` before the Adam step, so the
adaptive denominator never sees the decay.  The state is ``{"v", "s",
"t"}`` as Adam's, ``t`` a device int32 scalar."""

from __future__ import annotations

import torch

from .optimizer import Optimizer


class AdamW(Optimizer):
    def __init__(
        self,
        params,
        lr: float = 1e-3,
        betas=(0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 1e-2,
    ) -> None:
        super().__init__(params)
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay

    def init_state(self):
        return {"v": self._zeros_like_params(), "s": self._zeros_like_params(),
                "t": self._step_count()}

    def pure_update(self, params, grads, state, lr):
        t = state["t"] + 1
        tf = t.to(torch.float32)
        bc1 = 1.0 - self.beta1**tf
        bc2 = 1.0 - self.beta2**tf
        new_params, new_v, new_s = list(params), list(state["v"]), list(state["s"])
        for i, (p, g, v, s) in enumerate(zip(params, grads, state["v"], state["s"])):
            if g is None:
                continue
            p_dec = p * (1.0 - lr * self.weight_decay) if self.weight_decay else p
            v = v * self.beta1 + g * (1.0 - self.beta1)
            s = s * self.beta2 + g * g * (1.0 - self.beta2)
            update = (v / bc1) / ((s / bc2) ** 0.5 + self.eps) * lr
            new_params[i] = (p_dec - update).to(p.dtype)
            new_v[i], new_s[i] = v, s
        return new_params, {"v": new_v, "s": new_s, "t": t}
