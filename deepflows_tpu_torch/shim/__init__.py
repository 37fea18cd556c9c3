"""Runs the reference's scripts on the port: ``python -m
deepflows_tpu_torch.shim SCRIPT [ARGS]`` (see ``__main__.py``); the
``DeepFlows`` package here re-exports ``deepflows_tpu_torch``."""

import os

SHIM_DIR = os.path.dirname(os.path.abspath(__file__))
