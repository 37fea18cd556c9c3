"""The tape's grad flag (counterpart of ``deepflows_tpu/autograd.py``).

A process-wide flag with ``no_grad`` / ``enable_grad``, each a context
manager and a decorator.  It is the tape's, not torch's: while it is off
no tape ``Tensor`` joins ``Graph`` or asks for gradients, and the tape's
ops run under ``torch.no_grad()``, so they build no autograd graph.  Code
that works on plain ``torch.Tensor``s keeps torch's own grad mode whatever
the flag says; ``nn.Module.train()`` / ``eval()`` set the flag, as in the
JAX package, and ``flag_kept`` restores it around the port's own mode
switches.
"""

from __future__ import annotations

import contextlib
import functools

_grad_enabled: bool = True


def is_grad_enable() -> bool:
    return _grad_enabled


def is_grad_enabled() -> bool:
    return _grad_enabled


def set_grad_enabled(mode: bool) -> None:
    global _grad_enabled
    _grad_enabled = bool(mode)


@contextlib.contextmanager
def flag_kept():
    """Restore the flag on leaving the block: for the port's own code that
    switches a module's mode for its own ends (``train()`` and ``eval()``
    set the flag)."""
    prev = _grad_enabled
    try:
        yield
    finally:
        set_grad_enabled(prev)


class _GradMode:
    """Context manager / decorator that sets the flag and restores it."""

    _mode: bool = True

    def __init__(self):
        self._prev = None

    def __enter__(self):
        self._prev = _grad_enabled
        set_grad_enabled(self._mode)
        return self

    def __exit__(self, exc_type, exc, tb):
        set_grad_enabled(self._prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with self.__class__():
                return fn(*args, **kwargs)

        return wrapper


class no_grad(_GradMode):
    """Stop tape recording inside the block (or decorated function)."""

    _mode = False


class enable_grad(_GradMode):
    """Record on the tape inside the block (or decorated function)."""

    _mode = True
