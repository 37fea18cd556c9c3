from deepflows_tpu_torch.nn.parameter import Parameter  # noqa: F401
