"""An exponential moving average of a model's weights (counterpart of
``deepflows_tpu/optim/ema.py``).

The shadow weights are f32 copies (not aliases: an update that writes a
parameter in place must not move them) on each parameter's device, and
``update()`` folds the live weights in as ``s + (p - s) · (1 - d)``, in
f32 whatever the parameters' dtype.  With ``warmup`` the decay is
``min(decay, (1 + t) / (10 + t))`` after t updates.  Call ``update()``
once an optimizer step::

    ema = optim.ModelEMA(model, decay=0.999)
    for xb, yb in batches:
        step(xb, yb)
        ema.update()
    with ema.average_parameters():  # evaluate on the averaged weights
        ...
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch


class ModelEMA:
    def __init__(self, model, decay: float = 0.999, warmup: bool = True):
        if not (0.0 <= decay < 1.0):
            raise ValueError(f"decay must be in [0, 1), got {decay}")
        self.model = model
        self.decay = float(decay)
        self.warmup = warmup
        self.num_updates = 0
        self._named = list(model.named_parameters())
        with torch.no_grad():
            self._shadow = [p.detach().to(torch.float32, copy=True) for _, p in self._named]

    def _effective_decay(self) -> float:
        if not self.warmup:
            return self.decay
        t = self.num_updates
        return min(self.decay, (1.0 + t) / (10.0 + t))

    @torch.no_grad()
    def update(self) -> None:
        """Fold the model's current weights into the shadow average."""
        # 1 - d rounded as the JAX package rounds it: d to f32, then an f32
        # subtraction (exact in double, so one rounding to f32 at the use)
        d = float(np.float32(self._effective_decay()))
        w = float(np.float32(1.0) - np.float32(d))
        self.num_updates += 1
        for s, (_, p) in zip(self._shadow, self._named):
            s.add_((p.detach().float() - s) * w)

    @torch.no_grad()
    def copy_to(self, model=None) -> None:
        """Write the averaged weights into ``model`` (default: the tracked
        one), each cast to its parameter's dtype."""
        named = self._named if model is None else list(model.named_parameters())
        if len(named) != len(self._shadow):
            raise ValueError(
                f"model has {len(named)} parameters, EMA tracks {len(self._shadow)}")
        for (_, p), s in zip(named, self._shadow):
            p.copy_(s)

    @contextmanager
    def average_parameters(self):
        """Swap the averaged weights into the model for the block, and the
        live weights (the same tensors) back on exit."""
        saved = [p.data for _, p in self._named]
        for (_, p), s in zip(self._named, self._shadow):
            p.data = s.to(p.dtype, copy=True)
        try:
            yield self.model
        finally:
            for (_, p), d in zip(self._named, saved):
                p.data = d

    def state_dict(self) -> dict:
        return {
            "decay": self.decay,
            "warmup": self.warmup,
            "num_updates": self.num_updates,
            "shadow": {n: s.detach().clone() for (n, _), s in zip(self._named, self._shadow)},
        }

    def load_state_dict(self, state: dict) -> None:
        """Takes this class's state dict or the JAX package's (its shadow
        weights as numpy arrays)."""
        shadow = state["shadow"]
        missing = [n for n, _ in self._named if n not in shadow]
        if missing:
            raise KeyError(f"EMA state missing parameters: {missing}")
        self.decay = float(state["decay"])
        self.warmup = bool(state["warmup"])
        self.num_updates = int(state["num_updates"])
        self._shadow = [_f32_copy(shadow[n], p.device) for n, p in self._named]


def _f32_copy(s, device):
    if not isinstance(s, torch.Tensor):
        s = torch.from_numpy(np.array(s, dtype=np.float32))
    return s.to(device=device, dtype=torch.float32, copy=True)
