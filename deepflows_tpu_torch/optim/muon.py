"""Muon, momentum orthogonalised by Newton-Schulz (counterpart of
``deepflows_tpu/optim/muon.py``; Jordan et al. 2024).

For every parameter of 2 or more dims (a conv kernel seen as (out, -1)):

    m <- mu · m + g
    u =  g + mu · m          (nesterov; plain momentum takes m)
    p <- p - lr · sqrt(max(1, rows / cols)) · NS5(u)

``NS5`` is the quintic iteration ``X <- a X + (b A + c A²) X`` with
``A = X Xᵀ`` and (a, b, c) = (3.4445, -4.7750, 2.0315), after a Frobenius
normalisation, run on the transpose when rows > cols, in f32
(``torch.matmul``).  Parameters of fewer than 2 dims take AdamW inside the
same optimizer, at ``adamw_lr``, which keeps its ratio to ``lr`` so one
schedule drives both.  The state is ``{"m", "v", "t"}`` with ``v[i]``
None for every Muon parameter.
"""

from __future__ import annotations

import math

import torch

from .optimizer import Optimizer

_NS_COEFFS = (3.4445, -4.7750, 2.0315)


def ns_orthogonalize(x, steps: int = 5, eps: float = 1e-7):
    """Newton-Schulz orthogonalisation of a 2-D tensor: an approximation of
    the orthogonal factor U Vᵀ of its SVD."""
    a, b, c = _NS_COEFFS
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.T
    x = x / (((x * x).sum()) ** 0.5 + eps)
    for _ in range(steps):
        A = x @ x.T
        B = b * A + c * (A @ A)
        x = a * x + B @ x
    return x.T if transposed else x


class Muon(Optimizer):
    def __init__(
        self,
        params,
        lr: float = 0.02,
        momentum: float = 0.95,
        nesterov: bool = True,
        ns_steps: int = 5,
        weight_decay: float = 0.0,
        adamw_lr: float = 3e-4,
        adamw_betas=(0.9, 0.95),
        adamw_eps: float = 1e-8,
    ) -> None:
        super().__init__(params)
        self.lr = lr
        self.momentum = float(momentum)
        self.nesterov = bool(nesterov)
        self.ns_steps = int(ns_steps)
        self.weight_decay = float(weight_decay)
        self.adamw_lr_ratio = float(adamw_lr) / float(lr)
        self.adamw_beta1, self.adamw_beta2 = adamw_betas
        self.adamw_eps = float(adamw_eps)

    @staticmethod
    def _is_muon(p) -> bool:
        return p.dim() >= 2

    def init_state(self):
        m = self._zeros_like_params()
        v = [None if self._is_muon(p) else torch.zeros_like(s)
             for p, s in zip(self.params, m)]
        return {"m": m, "v": v, "t": self._step_count()}

    def pure_update(self, params, grads, state, lr):
        t = state["t"] + 1
        tf = t.to(torch.float32)
        bc1 = 1.0 - self.adamw_beta1**tf
        bc2 = 1.0 - self.adamw_beta2**tf
        new_params, new_m, new_v = list(params), list(state["m"]), list(state["v"])
        for i, (p, g, m, v) in enumerate(zip(params, grads, state["m"], state["v"])):
            if g is None:
                continue
            gf = g.float()
            if v is None:  # the Muon branch
                m = m * self.momentum + gf
                u = gf + m * self.momentum if self.nesterov else m
                rows = p.shape[0]
                cols = math.prod(p.shape[1:])
                o = ns_orthogonalize(u.reshape(rows, cols), self.ns_steps).reshape(p.shape)
                scale = max(1.0, rows / cols) ** 0.5
                p_dec = p * (1.0 - lr * self.weight_decay) if self.weight_decay else p
                new_p = p_dec - (lr * scale) * o
            else:  # the AdamW fallback
                alr = lr * self.adamw_lr_ratio
                m = m * self.adamw_beta1 + gf * (1.0 - self.adamw_beta1)
                v = v * self.adamw_beta2 + gf * gf * (1.0 - self.adamw_beta2)
                p_dec = p * (1.0 - alr * self.weight_decay) if self.weight_decay else p
                new_p = p_dec - alr * (m / bc1) / ((v / bc2) ** 0.5 + self.adamw_eps)
            new_params[i] = new_p.to(p.dtype)
            new_m[i], new_v[i] = m, v
        return new_params, {"m": new_m, "v": new_v, "t": t}
