"""The training loop (counterpart of ``deepflows_tpu/utils/trainer.py``):
``Trainer.fit`` over in-memory arrays with evaluation, early stop, a
checkpoint each epoch and per-epoch timing, on the whole-step path."""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..jit import CompiledEvalStep, CompiledTrainStep
from .data import data_loader
from .evaluate import Accumulator


class Trainer:
    """Training loop on ``CompiledTrainStep`` with evaluation, early stop,
    checkpointing and per-epoch timing.

    >>> trainer = Trainer(model, optimizer, criterion, scheduler=sch)
    >>> history = trainer.fit(x_train, y_train, x_test, y_test,
    ...                       epochs=10, batch_size=64)
    """

    def __init__(
        self,
        model,
        optimizer,
        criterion,
        scheduler=None,
        augment_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        checkpoint_path: Optional[str] = None,
        log_fn: Callable[[str], None] = print,
        step=None,
        eval_step=None,
    ):
        """``step`` and ``eval_step`` inject step objects built elsewhere
        (``CompiledTrainStep(lm.trunk(), opt, nn.LMHeadCrossEntropy(lm.head))``,
        or a step over a mesh: one with a ``mesh`` attribute gets host
        batches); the defaults are ``CompiledTrainStep(model, optimizer,
        criterion)`` and ``CompiledEvalStep(model)``."""
        self.model = model
        self.optimizer = optimizer
        self.criterion = criterion
        self.scheduler = scheduler
        self.augment_fn = augment_fn
        self.checkpoint_path = checkpoint_path
        self.log = log_fn
        self.step = step or CompiledTrainStep(model, optimizer, criterion)
        self.eval_step = eval_step or CompiledEvalStep(model)
        self.history = {"loss": [], "test_acc": [], "epoch_time": [], "lr": []}

    def _device(self):
        """Where batches are staged: the model's device."""
        return next(self.model.parameters()).device

    def evaluate(self, x, y, batch_size=256) -> float:
        """Accuracy of ``eval_step``'s argmax over ``x`` in batches: every
        step is queued, each argmax taken on the device, and the
        predictions read back once."""
        metric = Accumulator(2)
        batches = list(data_loader(x, y, batch_size))
        if not batches:
            return 0.0
        preds = torch.cat([self.eval_step(xb).argmax(1) for xb, _ in batches]).cpu().numpy()
        lo = 0
        for _, yb in batches:
            metric.add(float((preds[lo : lo + len(yb)] == yb).sum()), len(yb))
            lo += len(yb)
        return metric[0] / max(metric[1], 1)

    def fit(
        self,
        x_train,
        y_train,
        x_test=None,
        y_test=None,
        epochs: int = 10,
        batch_size: int = 64,
        shuffle: bool = True,
        target_acc: Optional[float] = None,
        eval_batch_size: int = 256,
        prefetch_size: int = 2,
        stage_on_device: bool = True,
    ) -> dict:
        """Train ``epochs`` epochs of full batches (``drop_last``), shuffled
        unseeded when ``shuffle``.  ``augment_fn`` runs in the loader's
        ``collate_fn``, on its prefetch thread; with ``stage_on_device``
        each batch is staged on the model's device there too, its copy
        free to run beside the previous step.  Each step's loss stays on
        the device and the epoch's mean is read back once."""
        augment = self.augment_fn
        collate = (lambda batch: (augment(batch[0]), batch[1])) if augment else None
        # a step over a mesh places host batches itself
        if hasattr(self.step, "mesh"):
            stage_on_device = False
        device = self._device() if stage_on_device else None
        for epoch in range(epochs):
            t0 = time.time()
            losses = []
            for xb, yb in data_loader(
                x_train,
                y_train,
                batch_size,
                shuffle=shuffle,
                drop_last=True,
                prefetch_size=prefetch_size,
                collate_fn=collate,
                device=device,
            ):
                losses.append(self.step(xb, yb))
            # one transfer for every step's loss
            per_step = (torch.stack([torch.as_tensor(v).float() for v in losses]).cpu().numpy()
                        if losses else np.zeros(0, np.float32))
            loss = float(np.mean(per_step))
            if self.scheduler is not None:
                self.scheduler.step()
            dt = time.time() - t0
            acc = (
                self.evaluate(x_test, y_test, eval_batch_size)
                if x_test is not None
                else float("nan")
            )
            self.history["loss"].append(loss)
            self.history["test_acc"].append(acc)
            self.history["epoch_time"].append(dt)
            self.history["lr"].append(self.optimizer.lr)
            self.log(f"epoch {epoch}: loss={loss:.4f} test_acc={acc:.4f} time={dt:.2f}s")
            if self.checkpoint_path:
                from .model_utils import save_checkpoint

                save_checkpoint(self.model, self.optimizer, epoch, loss, self.checkpoint_path)
            if target_acc is not None and acc * 100.0 >= target_acc:
                self.log(f"early stop at target accuracy {target_acc}%")
                break
        return self.history
