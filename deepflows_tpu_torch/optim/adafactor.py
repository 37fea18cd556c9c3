"""Adafactor, Adam with a factored second moment (counterpart of
``deepflows_tpu/optim/adafactor.py``; Shazeer & Stern 2018, with
``torch.optim.Adafactor``'s semantics).

- ``one_minus_beta2_t = t ** beta2_decay``, ``rho = min(lr, 1 / sqrt(t))``,
  ``alpha = max(eps2, RMS(p)) · rho``;
- a parameter of 2 or more dims keeps row and column mean-square EMAs over
  its last two axes, of shapes ``p.shape[:-1] + (1,)`` and
  ``p.shape[:-2] + (1, p.shape[-1])``, and ``var = (R @ C) /
  max(mean(R, -2), eps1)``; a vector keeps a full ``var`` EMA;
- update ``g · rsqrt(max(var, eps1²))``, scaled down by ``max(1,
  RMS(update) / d)``, decoupled weight decay.

The state is ``{"row", "col", "var", "t"}``; each list holds None where its
slot does not apply to the parameter.
"""

from __future__ import annotations

import torch

from .optimizer import Optimizer


def _rms(x):
    return ((x * x).mean()) ** 0.5


class Adafactor(Optimizer):
    def __init__(
        self,
        params,
        lr: float = 1e-2,
        beta2_decay: float = -0.8,
        eps: tuple = (None, 1e-3),
        d: float = 1.0,
        weight_decay: float = 0.0,
    ) -> None:
        super().__init__(params)
        if beta2_decay > 0:
            raise ValueError("beta2_decay must be <= 0")
        self.lr = lr
        self.beta2_decay = float(beta2_decay)
        # eps1 None: float32's machine epsilon
        self.eps1 = float(torch.finfo(torch.float32).eps if eps[0] is None else eps[0])
        self.eps2 = float(eps[1])
        self.d = float(d)
        self.weight_decay = float(weight_decay)

    def init_state(self):
        rows, cols, var = [], [], []
        for p in self.params:
            kw = dict(dtype=torch.float32, device=p.device)
            if p.dim() > 1:
                rows.append(torch.zeros(p.shape[:-1] + (1,), **kw))
                cols.append(torch.zeros(p.shape[:-2] + (1, p.shape[-1]), **kw))
                var.append(None)
            else:
                rows.append(None)
                cols.append(None)
                var.append(torch.zeros(p.shape, **kw))
        return {"row": rows, "col": cols, "var": var, "t": self._step_count()}

    def pure_update(self, params, grads, state, lr):
        t = state["t"] + 1
        tf = t.to(torch.float32)
        w2 = tf**self.beta2_decay  # one_minus_beta2_t
        rho = (1.0 / tf**0.5).clamp(max=lr)
        new_params = list(params)
        new_row, new_col, new_var = list(state["row"]), list(state["col"]), list(state["var"])
        for i, (p, g, R, C, V) in enumerate(
                zip(params, grads, state["row"], state["col"], state["var"])):
            if g is None:
                continue
            gf, pf = g.float(), p.float()
            alpha = _rms(pf).clamp(min=self.eps2) * rho
            p_dec = pf * (1.0 - lr * self.weight_decay) if self.weight_decay else pf
            g2 = gf * gf
            if p.dim() > 1:
                R = R + w2 * (g2.mean(-1, keepdim=True) - R)
                C = C + w2 * (g2.mean(-2, keepdim=True) - C)
                var = (R @ C) / R.mean(-2, keepdim=True).clamp(min=self.eps1)
            else:
                V = V + w2 * (g2 - V)
                var = V
            upd = gf / (var.clamp(min=self.eps1 * self.eps1) ** 0.5)
            denom = (_rms(upd) / self.d).clamp(min=1.0)
            new_params[i] = (p_dec - (alpha / denom) * upd).to(p.dtype)
            new_row[i], new_col[i], new_var[i] = R, C, V
        return new_params, {"row": new_row, "col": new_col, "var": new_var, "t": t}
