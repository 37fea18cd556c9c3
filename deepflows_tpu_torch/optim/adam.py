"""Adam (counterpart of ``deepflows_tpu/optim/adam.py``): the reference's EMA
order, bias correction and update sequence; t starts at 1.  The step count
lives in the state as a device int32 scalar, so the bias corrections are
computed on the device and a step needs no host sync."""

from __future__ import annotations

import torch

from ..ops.adam import fused_adam, fused_adam_sr
from .optimizer import Optimizer


class Adam(Optimizer):
    def __init__(
        self,
        params,
        lr: float = 1e-3,
        betas=(0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        fused: bool = False,
        stochastic_round: bool = False,
    ) -> None:
        """``fused=True`` updates every f32 parameter that has a gradient in
        one launch of the hand-written kernel ``ops.fused_adam`` (its plain
        twin for CPU tensors).  ``stochastic_round=True`` is full-bf16
        weight training: every bf16 parameter that has a gradient is
        updated in one launch of ``ops.fused_adam_sr``, which computes Adam
        in f32 and rounds the new value to bf16 stochastically, so updates
        below half a bf16 ulp still move the weight in expectation.  As in
        the JAX package, SR takes a bf16 parameter even when ``fused`` is
        also set; the moments stay f32; any other parameter takes the
        plain math, cast back to its dtype."""
        super().__init__(params)
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.fused = fused
        self.stochastic_round = stochastic_round
        self._consts = {}  # (device, b1, b2, eps, wd) -> f32[4] on the device

    def init_state(self):
        return {
            "v": self._zeros_like_params(),
            "s": self._zeros_like_params(),
            "t": self._step_count(),
        }

    def _hyper(self, lr, bc1, bc2):
        """The kernel's f32[7] on the state's device, built by device ops."""
        dev = bc1.device
        vals = (self.beta1, self.beta2, self.eps, self.weight_decay)
        consts = self._consts.get((dev, *vals))
        if consts is None:
            consts = torch.tensor(vals, dtype=torch.float32).to(dev)
            self._consts = {(dev, *vals): consts}
        if isinstance(lr, torch.Tensor):  # lazy mode's graph reads lr from the card
            lr_t = lr.reshape(1).to(torch.float32)
        else:
            lr_t = torch.full((1,), lr, dtype=torch.float32, device=dev)
        return torch.cat([lr_t, consts, bc1.reshape(1), bc2.reshape(1)])

    def pure_update(self, params, grads, state, lr):
        t = state["t"] + 1
        tf = t.to(torch.float32)
        bc1 = 1.0 - self.beta1**tf
        bc2 = 1.0 - self.beta2**tf
        new_params, new_v, new_s = list(params), list(state["v"]), list(state["s"])
        live = [i for i, g in enumerate(grads) if g is not None]
        sr = [i for i in live
              if self.stochastic_round and params[i].dtype == torch.bfloat16]
        fused = [i for i in live if self.fused and i not in sr]
        for i in fused:
            if params[i].dtype != torch.float32:
                raise TypeError(
                    f"Adam(fused=True) updates f32 parameters, got {params[i].dtype}"
                )
        hyper = self._hyper(lr, bc1, bc2) if sr or fused else None
        # the kernels take contiguous tensors; autograd may hand back a
        # strided gradient (the MoE router's weight, for one)
        if sr:
            fused_adam_sr(
                [params[i] for i in sr],
                [(grads[i] if grads[i].dtype == torch.bfloat16 else grads[i].float())
                 .contiguous() for i in sr],
                [new_v[i] for i in sr], [new_s[i] for i in sr], hyper, t, indices=sr,
            )
        if fused:
            fused_adam(
                [params[i] for i in fused], [grads[i].float().contiguous() for i in fused],
                [new_v[i] for i in fused], [new_s[i] for i in fused], hyper,
            )
        for i in sorted(set(live) - set(sr) - set(fused)):
            p, g, v, s = params[i], grads[i], new_v[i], new_s[i]
            if self.weight_decay:
                g = g + p * self.weight_decay
            v = v * self.beta1 + g * (1.0 - self.beta1)
            s = s * self.beta2 + g * g * (1.0 - self.beta2)
            v_hat = v / bc1
            s_hat = s / bc2
            update = v_hat / (s_hat**0.5 + self.eps) * lr
            new_params[i] = (p - update).to(p.dtype)
            new_v[i], new_s[i] = v, s
        return new_params, {"v": new_v, "s": new_s, "t": t}

    @property
    def elementwise(self):
        """Stochastic rounding draws each element's bits from its index in
        the whole tensor, so it updates whole values."""
        return not self.stochastic_round

    @property
    def v(self):
        self._ensure_state()
        return self._state["v"]

    @property
    def s(self):
        self._ensure_state()
        return self._state["s"]

    @property
    def t(self):
        """The reference's step count, which starts at 1."""
        self._ensure_state()
        return int(self._state["t"]) + 1
