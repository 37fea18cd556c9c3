"""``DeviceDataLoader`` (counterpart of
``deepflows_tpu/utils/data/device_loader.py``): stages a loader's batches on
a device one batch ahead.  Batch N+1's copies are issued, on the loader's
side stream as ``DataLoader(device=...)`` issues them, before batch N is
handed over, so they can run beside step N."""

from __future__ import annotations

from ...device import Device
from .dataloader import _Stager


class DeviceDataLoader:
    def __init__(self, loader, device=None):
        """``device``: None (the CUDA card, which must be present), a CUDA
        device or ``"cpu"``."""
        self.loader = loader
        self.device = Device(device)

    def __iter__(self):
        stager = _Stager(self.device)
        it = iter(self.loader)
        try:
            nxt = stager.stage(next(it))
        except StopIteration:
            return
        for batch in it:
            cur, nxt = nxt, stager.stage(batch)  # stage ahead, then hand over
            yield stager.ready(cur)
        yield stager.ready(nxt)

    def __len__(self):
        return len(self.loader)
