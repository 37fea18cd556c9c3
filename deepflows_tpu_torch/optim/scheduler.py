"""Learning-rate schedulers (counterpart of ``deepflows_tpu/optim/scheduler.py``):
host arithmetic that sets ``optimizer.lr``, which every update reads at
its call.  The formulas, the epoch count starting at -1 and the state
dicts (every attribute but the optimizer) are the JAX package's."""

from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, optimizer) -> None:
        self.optimizer = optimizer
        self.last_epoch = -1

    def step(self):
        self.last_epoch += 1

    def state_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items() if k != "optimizer"}

    def load_state_dict(self, sd: dict) -> None:
        self.__dict__.update(sd)

    def _base_lr(self):
        return self.optimizer.lr if hasattr(self.optimizer, "lr") else None


class StepLR(LRScheduler):
    """lr times ``gamma`` every ``step_size`` epochs."""

    def __init__(self, optimizer, step_size: int, gamma: float = 0.1) -> None:
        super().__init__(optimizer)
        self.step_size = step_size
        self.gamma = gamma

    def step(self):
        super().step()
        if self.last_epoch != 0 and self.last_epoch % self.step_size == 0:
            if hasattr(self.optimizer, "lr"):
                self.optimizer.lr = self.optimizer.lr * self.gamma


class CosineAnnealingLR(LRScheduler):
    """Half a cosine from the base lr down to ``eta_min`` over ``T_max``
    epochs, cycling (the epoch is taken modulo ``T_max``)."""

    def __init__(self, optimizer, T_max: int, eta_min: float = 0.0) -> None:
        super().__init__(optimizer)
        self.T_max = T_max
        self.eta_min = eta_min
        self.base_lr = self._base_lr()

    def step(self):
        super().step()
        if self.base_lr is None:
            return
        t = self.last_epoch % self.T_max
        self.optimizer.lr = (
            self.eta_min
            + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * t / self.T_max)) / 2
        )


class LinearLR(LRScheduler):
    """``torch.optim.lr_scheduler.LinearLR``: from ``base_lr ·
    start_factor`` to ``base_lr · end_factor`` over ``total_iters`` steps,
    then held."""

    def __init__(self, optimizer, start_factor: float = 1.0 / 3,
                 end_factor: float = 1.0, total_iters: int = 5) -> None:
        super().__init__(optimizer)
        self.start_factor = float(start_factor)
        self.end_factor = float(end_factor)
        self.total_iters = int(total_iters)
        self.base_lr = self._base_lr()

    def step(self):
        super().step()
        if self.base_lr is None:
            return
        t = min(self.last_epoch, self.total_iters)
        f = self.start_factor + (self.end_factor - self.start_factor) * (
            t / max(1, self.total_iters))
        self.optimizer.lr = self.base_lr * f


class OneCycleLR(LRScheduler):
    """``torch.optim.lr_scheduler.OneCycleLR`` with cosine annealing: up
    from ``max_lr / div_factor`` to ``max_lr`` over the first
    ``pct_start`` of ``total_steps``, then down to ``max_lr / div_factor /
    final_div_factor``; the first lr is set at construction."""

    def __init__(self, optimizer, max_lr: float, total_steps: int,
                 pct_start: float = 0.3, div_factor: float = 25.0,
                 final_div_factor: float = 1e4) -> None:
        super().__init__(optimizer)
        self.max_lr = float(max_lr)
        self.total_steps = int(total_steps)
        self.pct_start = float(pct_start)
        self.initial_lr = self.max_lr / float(div_factor)
        self.min_lr = self.initial_lr / float(final_div_factor)
        self.step()

    @staticmethod
    def _anneal(start, end, pct):
        return end + (start - end) * (1 + math.cos(math.pi * pct)) / 2

    def step(self):
        super().step()
        t = min(self.last_epoch, self.total_steps - 1)
        up = self.pct_start * self.total_steps - 1  # torch's end of the warm-up
        if t <= up:
            lr = self._anneal(self.initial_lr, self.max_lr, t / max(1e-9, up))
        else:
            down = (t - up) / max(1e-9, (self.total_steps - 1) - up)
            lr = self._anneal(self.max_lr, self.min_lr, down)
        self.optimizer.lr = lr


class WarmupCosineLR(LRScheduler):
    """A linear warm-up from ``warmup_start_lr`` to the base lr over
    ``warmup_epochs`` (epoch 0 gives ``warmup_start_lr``), then half a
    cosine down to ``eta_min`` over ``T_max``."""

    def __init__(
        self,
        optimizer,
        warmup_epochs: int,
        T_max: int,
        base_lr: float = None,
        warmup_start_lr: float = 0.0,
        eta_min: float = 0.0,
    ) -> None:
        super().__init__(optimizer)
        self.warmup_epochs = warmup_epochs
        self.T_max = T_max
        self.eta_min = eta_min
        self.base_lr = base_lr if base_lr is not None else self._base_lr()
        self.warmup_start_lr = warmup_start_lr

    def step(self):
        super().step()
        if self.base_lr is None:
            return
        if self.last_epoch <= self.warmup_epochs and self.warmup_epochs > 0:
            t = self.last_epoch
            lr = self.warmup_start_lr + (self.base_lr - self.warmup_start_lr) * (
                t / max(1, self.warmup_epochs))
        else:
            t = max(0, self.last_epoch - self.warmup_epochs)
            lr = (self.eta_min + (self.base_lr - self.eta_min)
                  * (1 + math.cos(math.pi * t / max(1, self.T_max))) / 2)
        self.optimizer.lr = lr
