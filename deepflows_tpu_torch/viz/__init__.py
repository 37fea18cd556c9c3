"""Live-training visualization platform (counterpart of ``deepflows_tpu/viz``;
reference: ``Visualization_backend/`` and ``Visualization_frontend/``).
``python -m deepflows_tpu_torch.viz.server`` serves it on port 8000."""

from .server import (
    AVAILABLE_MODELS,
    ConnectionManager,
    build_dynamic_model,
    make_server,
    train_worker,
)

__all__ = [
    "make_server",
    "ConnectionManager",
    "build_dynamic_model",
    "train_worker",
    "AVAILABLE_MODELS",
]
