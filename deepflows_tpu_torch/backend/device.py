"""Device registry (counterpart of ``deepflows_tpu/backend/device.py``).

A ``BackendDevice`` is a named device bound to a kernel module: ``cpu``
is torch on the CPU and ``cuda`` the card, both over ``torch_kernels``;
``cpu_native`` is the CPU over ``native_kernels``, the C++ kernel library
(the JAX package's ``backend/native/kernels.cpp``, built with g++ at first
use; a tape Tensor made there is a ``tensor.NativeTensor``, whose ops run
on that library where it fits them).
``Device('cuda')``, ``Device('gpu')`` and ``Device('tpu')`` all name the
card, so the reference's scripts (``device='cuda'``) and the JAX
package's (``device='tpu'``) run unchanged.

This is the port's one device registry.  ``deepflows_tpu_torch.device``'s
``Device(name)``, which every ``device=`` argument of the port's entry
points goes through, is this ``Device(name).torch_device``: the
``torch.device`` of the registry's device, so the two agree on every name
and on ``None``, and every ``device=`` argument takes either kind.  A tape
``Tensor``'s ``.device`` stays torch's own ``torch.device``, which compares
equal to the ``BackendDevice`` of the same device.

Differences from the JAX package, on purpose:

- ``default_device()``, the device of ``Tensor(x)`` without ``device=``, is
  the card, as every entry point of the port defaults to it: a run meant
  for the card never measures the host.  The CPU is chosen by
  ``device='cpu'`` or by ``DEEPFLOWS_BACKEND=cpu``.  The JAX package's
  default is the CPU unless ``DEEPFLOWS_BACKEND`` names another device.
- A card named by ``device=``, by ``DEEPFLOWS_BACKEND`` or by the default
  when no card is present raises, and so does an unknown name in
  ``DEEPFLOWS_BACKEND``; the JAX package warns and falls back to the CPU.
- ``Device('cpu_native')`` builds its library and raises with the
  compiler's output if the build fails; the JAX package's device stays
  registered but disabled and its tensors fall to NumPy.

Each device's ``manual_seed``, ``randn``, ``rand``, ``uniform``,
``randint`` and ``dropout_mask`` draw from the package generator of that
device (``random.py``), never from torch's global generator.
"""

from __future__ import annotations

import os

import torch

from . import native_kernels, torch_kernels

# the protocol functions that make a tensor: a device binds its torch.device
_MAKES = frozenset(("from_numpy", "fill", "scatter_add", "randn", "rand",
                    "uniform", "randint", "dropout_mask", "one_hot", "manual_seed"))

class BackendDevice:
    """A device name bound to a kernel module, with its ``torch.device``."""

    def __init__(self, name: str, torch_device: torch.device, kernels=torch_kernels):
        self.name = name
        self.torch_device = torch_device
        self.kernels = kernels

    def __getattr__(self, attr):
        fn = getattr(self.kernels, attr)
        if attr in _MAKES:
            dev = self.torch_device
            return lambda *a, **k: fn(*a, device=dev, **k)
        return fn

    def enabled(self) -> bool:
        return True

    def __deepcopy__(self, memo):
        return self  # process-wide singletons

    def __eq__(self, other):
        if isinstance(other, BackendDevice):
            return self.torch_device == other.torch_device and self.kernels is other.kernels
        if isinstance(other, torch.device):
            return self.torch_device == _normalise(other)
        return NotImplemented

    def __hash__(self):
        return hash(self.torch_device)

    def __repr__(self):
        return self.name

    # convenience factories (the JAX package's)
    def randn(self, *shape, dtype=None, seed=None):
        from .ndarray import BackendTensor

        return BackendTensor._wrap(torch_kernels.randn(
            shape, dtype=dtype, seed=seed, device=self.torch_device), self)

    def rand(self, *shape, dtype=None, seed=None):
        from .ndarray import BackendTensor

        return BackendTensor._wrap(torch_kernels.rand(
            shape, dtype=dtype, seed=seed, device=self.torch_device), self)

    def one_hot(self, indices, num_classes, dtype=None):
        from .ndarray import BackendTensor

        return BackendTensor._wrap(torch_kernels.one_hot(
            indices, num_classes, dtype=dtype, device=self.torch_device), self)

    def empty(self, shape, dtype=None):
        return self.full(shape, 0.0, dtype=dtype)

    def full(self, shape, fill_value, dtype=None):
        from .ndarray import BackendTensor

        return BackendTensor._wrap(torch_kernels.fill(
            shape, fill_value, dtype=dtype, device=self.torch_device), self)


_devices: dict = {}


def _normalise(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' or set "
                               "DEEPFLOWS_BACKEND=cpu to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _registered(dev: torch.device) -> BackendDevice:
    dev = _normalise(dev)
    d = _devices.get(dev)
    if d is None:
        if dev.type == "cuda":
            if not torch.cuda.is_available() or dev.index >= torch.cuda.device_count():
                raise RuntimeError(f"no CUDA device {dev} is available; pass device='cpu'"
                                   " or set DEEPFLOWS_BACKEND=cpu to run on the CPU")
            name = "cuda" if dev.index == torch.cuda.current_device() else str(dev)
        else:
            name = "cpu"
        d = _devices[dev] = BackendDevice(name, dev)
    return d


def cpu() -> BackendDevice:
    return _registered(torch.device("cpu"))


def cpu_numpy() -> BackendDevice:
    return cpu()


def cuda() -> BackendDevice:
    """The card; raises without one."""
    return _registered(torch.device("cuda"))


tpu = cuda  # the JAX package's accelerator name


_native = None


def cpu_native() -> BackendDevice:
    """The CPU over the C++ kernel library, built at the first call (a failed
    build raises with the compiler's output)."""
    global _native
    if _native is None:
        native_kernels.load()
        _native = BackendDevice("cpu_native", torch.device("cpu"), native_kernels)
    return _native


def default_device() -> BackendDevice:
    """The device of a tensor made without ``device=``: the card (an error
    without one), or the device that ``DEEPFLOWS_BACKEND`` names (re-read
    on every call; ``cpu`` or ``np`` for the CPU, ``nd`` for the default,
    an unknown name raises)."""
    name = os.environ.get("DEEPFLOWS_BACKEND", "").strip().lower()
    if name in ("", "nd"):
        return cuda()
    if name == "np":
        return cpu()
    try:
        return Device(name)
    except ValueError:
        raise ValueError(f"DEEPFLOWS_BACKEND={name!r} is not a known device") from None


def default_accelerator() -> BackendDevice:
    """The card, or an error."""
    return cuda()


def all_devices():
    """The CPU and every card present."""
    return [cpu()] + [_registered(torch.device("cuda", i))
                      for i in range(torch.cuda.device_count())]


def Device(name=None) -> BackendDevice:
    """The registry's device for ``name``: a ``BackendDevice``, a
    ``torch.device``, ``"cpu"``, or ``"cuda"`` / ``"gpu"`` / ``"tpu"``
    (``"cuda:N"`` too) for the card; None is the default device."""
    if isinstance(name, BackendDevice):
        return name
    if name is None:
        return default_device()
    if isinstance(name, torch.device):
        return _registered(name)
    if not isinstance(name, str):
        raise ValueError(f"unknown device: {name!r}")
    key = name.strip().lower()
    if key == "cpu_native":
        return cpu_native()
    if key in ("gpu", "tpu"):
        key = "cuda"
    try:
        dev = torch.device(key)
    except RuntimeError:
        raise ValueError(f"unknown device: {name!r}") from None
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unknown device: {name!r}")
    return _registered(dev)
