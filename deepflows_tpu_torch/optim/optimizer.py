"""Optimizer base (counterpart of ``deepflows_tpu/optim/optimizer.py``).

Every optimizer defines ``pure_update(params, grads, state, lr) ->
(new_params, new_state)`` over plain tensors, with ``grads`` entries that
may be None.  The eager ``step()`` feeds the parameters' data and ``.grad``
through it and writes the result back; ``jit.CompiledTrainStep`` calls the
same function with the gradients of its step.  ``lr`` is read from
``self.lr`` at every call, so a schedule only has to set it.

Unlike the JAX package's pure functions, an update may work in place (the
fused Adam route does, on the parameter tensors it is given); it returns
the tensors that hold the new values either way.  State slots are f32
whatever the parameter dtype.
"""

from __future__ import annotations

import torch


class Optimizer:
    def __init__(self, params) -> None:
        self.params = list(params)
        self._state = None

    def init_state(self):
        """The state: per-parameter slots and counters, as tensors."""
        return {}

    def pure_update(self, params, grads, state, lr):
        raise NotImplementedError

    def _ensure_state(self):
        if self._state is None:
            self._state = self.init_state()

    @torch.no_grad()
    def step(self):
        self._ensure_state()
        data = [p.data for p in self.params]
        new_params, self._state = self.pure_update(
            data, [p.grad for p in self.params], self._state, self.lr
        )
        for p, old, new in zip(self.params, data, new_params):
            if new is not old:
                p.data = new

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        self._ensure_state()
        return {"state": self._state, "lr": self.lr}

    def load_state_dict(self, sd: dict) -> None:
        self._state = sd.get("state")
        if "lr" in sd:
            self.lr = sd["lr"]

    def _zeros_like_params(self):
        """f32 zero slots, one per parameter, on its device."""
        return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in self.params]

    def _step_count(self):
        """A step count at 0: an int32 scalar on the first parameter's
        device, so the bias corrections are computed there with no host
        sync."""
        dev = self.params[0].device if self.params else torch.device("cpu")
        return torch.zeros((), dtype=torch.int32, device=dev)
