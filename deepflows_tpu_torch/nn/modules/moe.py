"""Mixture-of-Experts FFN (counterpart of ``deepflows_tpu/nn/modules/moe.py``)
and ``MoECriterion``.

The E experts' weights are stacked on a leading expert axis
(``experts_w1: (E, D, H)``, or ``experts_gate/up/down`` for SwiGLU
experts), every expert's output is one batched product, and the
gate-weighted combine sums the expert axis.  Three gating modes: the dense
softmax mixture (default), top-k masked and renormalised (``top_k=``), and
Switch-style sparse top-1 dispatch with a static capacity
(``capacity_factor=``).
"""

from __future__ import annotations

import math

import torch

from ... import _data_axis as data_axis
from ...config import config
from ...device import Device
from .. import functional as F
from .. import init
from .linear import Linear
from ..parameter import Parameter
from .module import Module


class MoE(Module):
    def __init__(
        self,
        dim: int,
        hidden: int,
        n_experts: int,
        activation: str = "gelu",
        top_k: int = 0,
        capacity_factor: float = 0.0,
        device=None,
        swiglu: bool = False,
    ) -> None:
        """``top_k > 0``: the softmax gates are masked to each token's k
        largest (``F.topk_mask``, ties at the k-th value kept) and
        renormalised; every expert still runs every token.  ``top_k=0``
        is the dense softmax mixture.

        ``capacity_factor > 0``: sparse top-1 dispatch (Switch
        Transformer): each token goes to its argmax expert weighted by the
        raw top gate, each expert takes at most ``C = ceil(N / E ·
        capacity_factor)`` tokens in token order, and the others are
        dropped (zero output).  Exclusive with ``top_k``.

        ``swiglu=True``: each expert is a bias-free SwiGLU FFN
        ``down(silu(gate(x)) * up(x))`` (Mixtral's), with dense or top-k
        gating only.

        Each forward records the Switch load-balancing loss
        (``last_aux_loss``), the router z-loss (``last_z_loss``), each
        expert's share of argmax tokens (``last_expert_fraction``) and,
        under capacity, the share of tokens dropped
        (``last_dropped_fraction``); ``MoECriterion`` adds the first two
        to the task loss."""
        super().__init__()
        if top_k < 0 or top_k > n_experts:
            raise ValueError(f"top_k={top_k} out of range for {n_experts} experts")
        if capacity_factor < 0:
            raise ValueError(f"capacity_factor must be >= 0, got {capacity_factor}")
        if capacity_factor and top_k:
            raise ValueError("capacity_factor and top_k are mutually exclusive")
        if swiglu and capacity_factor:
            raise ValueError(
                "swiglu experts support dense/top-k gating only "
                "(capacity_factor dispatch is the gelu/relu Switch path)"
            )
        self.dim, self.hidden, self.n_experts = dim, hidden, n_experts
        self.activation = activation
        self.top_k = top_k
        self.capacity_factor = float(capacity_factor)
        self.swiglu = bool(swiglu)
        self.last_aux_loss = None
        self.last_z_loss = None
        self.last_expert_fraction = None
        self.last_dropped_fraction = None
        dev = Device(device)
        kw = dict(device=dev, dtype=config.default_dtype)
        self.router = Linear(dim, n_experts, device=dev)
        # kaiming-uniform(a=√5) with each expert's own 2-D fan:
        # bound 1/√fan_in, fan_in the expert matrix's input width
        bound_d, bound_h = 1.0 / math.sqrt(dim), 1.0 / math.sqrt(hidden)
        if self.swiglu:
            for name, shape, bound in (
                ("experts_gate", (n_experts, dim, hidden), bound_d),
                ("experts_up", (n_experts, dim, hidden), bound_d),
                ("experts_down", (n_experts, hidden, dim), bound_h),
            ):
                par = Parameter(torch.empty(shape, **kw))
                init.uniform_(par, -bound, bound)
                self.register_parameter(name, par)
            return
        self.experts_w1 = Parameter(torch.empty((n_experts, dim, hidden), **kw))
        self.experts_b1 = Parameter(torch.zeros((n_experts, 1, hidden), **kw))
        self.experts_w2 = Parameter(torch.empty((n_experts, hidden, dim), **kw))
        self.experts_b2 = Parameter(torch.zeros((n_experts, 1, dim), **kw))
        init.uniform_(self.experts_w1, -bound_d, bound_d)
        init.uniform_(self.experts_w2, -bound_h, bound_h)

    def _act(self, h):
        return F.gelu(h) if self.activation == "gelu" else F.relu(h)

    def forward(self, x):
        # x: (B, L, D) or (N, D)
        logits = self.router(x)  # (..., E)
        self._record_aux(logits)
        if self.capacity_factor:
            return self._sparse_forward(x, logits)
        self.last_dropped_fraction = None  # dense and top-k compute drop nothing
        D, E = x.shape[-1], self.n_experts
        N = x.numel() // D
        gates = F.softmax(logits, x.dim() - 1)
        if self.top_k and self.top_k < E:
            kept = gates * F.topk_mask(gates, self.top_k)
            gates = kept / kept.sum(-1, keepdim=True)
        # every expert's product is one bmm; a (1, N, D) @ (E, D, H)
        # broadcast would copy each expert stack transposed, forward and
        # backward
        xf = x.reshape(1, N, D).expand(E, N, D)
        if self.swiglu:
            g = F.silu(xf @ self.experts_gate)  # (E, N, H)
            out_e = (g * (xf @ self.experts_up)) @ self.experts_down  # (E, N, D)
        else:
            h = self._act(xf @ self.experts_w1 + self.experts_b1)
            out_e = h @ self.experts_w2 + self.experts_b2
        g = gates.reshape(N, E).transpose(0, 1).reshape(E, N, 1)
        return (out_e * g).sum(0).reshape(x.shape)

    def _record_aux(self, logits):
        """The Switch load-balancing loss ``E · Σ_e f_e · P_e`` (f_e the
        share of tokens whose argmax expert is e, constant; P_e the mean
        router probability), the router z-loss ``mean(logsumexp(logits)²)``
        and f as ``last_expert_fraction`` (f32)."""
        E = self.n_experts
        flat = logits.detach().reshape(-1, E)
        # over the global batch inside a sharded step (_data_axis)
        f = data_axis.mean(torch.nn.functional.one_hot(flat.argmax(-1), E).float().mean(0))
        P = data_axis.mean(F.softmax(logits, logits.dim() - 1).reshape(-1, E).mean(0))
        self.last_aux_loss = (f.to(logits.dtype) * P).sum() * float(E)
        m = torch.amax(logits, -1, keepdim=True)
        lse = torch.log(torch.exp(logits - m).sum(-1, keepdim=True)) + m
        self.last_z_loss = (lse * lse).mean()
        self.last_expert_fraction = f

    def _sparse_forward(self, x, logits):
        """Switch top-1 dispatch: (N, E, C) one-hot dispatch and combine
        tensors, the expert FFNs on (E, C, D) slots.  The routing
        bookkeeping is f32 whatever x's dtype (a bf16 cumulative sum is
        inexact past 256 tokens).

        Inside a sharded step the capacity and the slot order count the
        global batch's tokens (the ranks' rows in rank order): a token's
        slot is its place among this rank's tokens of its expert after the
        earlier ranks' counts.  Each rank computes the experts on its own
        tokens, in ``min(C, n)`` slots an expert for its n tokens (its
        kept tokens of one expert are fewer than both)."""
        D, E = x.shape[-1], self.n_experts
        xf = x.reshape(-1, D)
        n = xf.shape[0]
        N = n * data_axis.size()
        C = max(1, int(math.ceil(N / E * self.capacity_factor)))
        gates = torch.softmax(logits.reshape(n, E), -1)
        e_t = gates.detach().argmax(-1)  # routing is constant under autograd
        g_t = gates.gather(1, e_t[:, None])[:, 0]
        onehot = torch.nn.functional.one_hot(e_t, E).float()  # (n, E)
        local = (torch.cumsum(onehot, 0) - 1.0) * onehot
        pos = local + data_axis.before(onehot.sum(0)) * onehot
        keep = torch.where(pos < C, onehot, 0.0)
        slots = min(C, n)
        posc = local.clamp(0, slots - 1).long()
        disp = (keep[..., None] * torch.nn.functional.one_hot(posc, slots).float()).to(xf.dtype)
        xe = torch.einsum("nec,nd->ecd", disp, xf)
        h = self._act(torch.einsum("ecd,edh->ech", xe, self.experts_w1) + self.experts_b1)
        ye = torch.einsum("ech,ehd->ecd", h, self.experts_w2) + self.experts_b2
        y = torch.einsum("nec,ecd->nd", disp, ye) * g_t[:, None]
        self.last_dropped_fraction = 1.0 - data_axis.total(keep.sum()) / N
        return y.reshape(x.shape)

    def extra_repr(self) -> str:
        if self.capacity_factor:
            gate = f"switch-top1(capacity_factor={self.capacity_factor})"
        elif self.top_k:
            gate = f"top{self.top_k}"
        else:
            gate = "dense-softmax"
        return (
            f"dim={self.dim}, hidden={self.hidden}, "
            f"n_experts={self.n_experts}, gating={gate}"
        )


class MoECriterion(Module):
    """The base task loss plus every MoE submodule's load-balancing loss
    (weight ``aux_weight``, the Switch paper's 1e-2) and router z-loss
    (``z_weight``, ST-MoE's 1e-3), as recorded by the forward that the
    same step ran."""

    def __init__(self, base, model: Module, aux_weight: float = 1e-2,
                 z_weight: float = 1e-3):
        super().__init__()
        self.base = base
        moes = [m for m in model.modules() if isinstance(m, MoE)]
        if not moes:
            raise ValueError("model has no MoE submodules")
        object.__setattr__(self, "_moes", moes)
        self.aux_weight = float(aux_weight)
        self.z_weight = float(z_weight)

    @property
    def reduction(self):
        return getattr(self.base, "reduction", "mean")

    def forward(self, input, target):
        loss = self.base(input, target)
        for m in self._moes:
            if self.aux_weight and m.last_aux_loss is not None:
                loss = loss + m.last_aux_loss * self.aux_weight
            if self.z_weight and m.last_z_loss is not None:
                loss = loss + m.last_z_loss * self.z_weight
        return loss
