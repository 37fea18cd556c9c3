"""Sequential (counterpart of ``deepflows_tpu/nn/modules/container.py``).

Children are named ``"0"``, ``"1"``, … so that state_dict keys match the
JAX package's (``blocks.3.mlp.0.weight``).
"""

from __future__ import annotations

from .module import Module


class Sequential(Module):
    def __init__(self, *modules):
        super().__init__()
        for idx, module in enumerate(modules):
            self.add_module(str(idx), module)

    def __getitem__(self, idx: int):
        return list(self._modules.values())[idx]

    def __len__(self) -> int:
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for module in self._modules.values():
            x = module(x)
        return x
