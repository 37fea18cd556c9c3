"""gRPC serving (counterpart of ``deepflows_tpu/serving``): Predict and
Generate over the JAX package's wire protocol."""

from .serving import MyDLPWServicer, PredictClient, PredictService

__all__ = ["MyDLPWServicer", "PredictClient", "PredictService"]
