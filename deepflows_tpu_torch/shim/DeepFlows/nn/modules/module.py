from deepflows_tpu_torch.nn.modules.module import Module  # noqa: F401
