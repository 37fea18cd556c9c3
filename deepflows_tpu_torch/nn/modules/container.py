"""Containers (counterpart of ``deepflows_tpu/nn/modules/container.py``):
``Sequential``, ``ModuleList`` and ``ModuleDict``.

Children of ``Sequential`` and ``ModuleList`` are named ``"0"``, ``"1"``, …
so that state_dict keys match the JAX package's (``blocks.3.mlp.0.weight``).
Deleting from a ``ModuleList`` renumbers the rest, so its keys stay
``0..n-1`` as in JAX; ``Sequential`` keeps its names, as JAX's does.
"""

from __future__ import annotations

import operator
from collections import OrderedDict
from typing import Dict, Iterable, Iterator, Optional

from .module import Module


class Sequential(Module):
    def __init__(self, *args):
        super().__init__()
        if len(args) == 1 and isinstance(args[0], OrderedDict):
            for key, module in args[0].items():
                self.add_module(key, module)
        else:
            for idx, module in enumerate(args):
                self.add_module(str(idx), module)

    def _key(self, idx) -> str:
        size = len(self)
        idx = operator.index(idx)
        if not -size <= idx < size:
            raise IndexError(f"index {idx} is out of range")
        return list(self._modules)[idx % size]

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return self.__class__(OrderedDict(list(self._modules.items())[idx]))
        return self._modules[self._key(idx)]

    def __setitem__(self, idx: int, module: Module) -> None:
        setattr(self, self._key(idx), module)

    def __delitem__(self, idx) -> None:
        keys = list(self._modules)[idx] if isinstance(idx, slice) else [self._key(idx)]
        for key in keys:
            delattr(self, key)

    def __len__(self) -> int:
        return len(self._modules)

    def __iter__(self) -> Iterator[Module]:
        return iter(self._modules.values())

    def __add__(self, other) -> "Sequential":
        if not isinstance(other, Sequential):
            raise ValueError(f"add operator supports only Sequential, got {type(other)}")
        return Sequential(*self, *other)

    def append(self, module: Module) -> "Sequential":
        self.add_module(str(len(self)), module)
        return self

    def extend(self, sequential) -> "Sequential":
        for layer in sequential:
            self.append(layer)
        return self

    def forward(self, x):
        for module in self._modules.values():
            x = module(x)
        return x


class ModuleList(Module):
    def __init__(self, modules: Optional[Iterable[Module]] = None) -> None:
        super().__init__()
        if modules is not None:
            self.extend(modules)

    def _key(self, idx) -> str:
        idx = operator.index(idx)
        if not -len(self) <= idx < len(self):
            raise IndexError(f"index {idx} is out of range")
        return str(idx % len(self))

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return self.__class__(list(self._modules.values())[idx])
        return self._modules[self._key(idx)]

    def __setitem__(self, idx: int, module: Module) -> None:
        setattr(self, self._key(idx), module)

    def __delitem__(self, idx) -> None:
        keys = ([str(k) for k in range(len(self))[idx]] if isinstance(idx, slice)
                else [self._key(idx)])
        for key in keys:
            delattr(self, key)
        # renumber in place, so the keys stay 0..n-1
        rest = list(self._modules.values())
        self._modules.clear()
        for i, module in enumerate(rest):
            self._modules[str(i)] = module

    def __len__(self) -> int:
        return len(self._modules)

    def __iter__(self) -> Iterator[Module]:
        return iter(self._modules.values())

    def __iadd__(self, modules: Iterable[Module]) -> "ModuleList":
        return self.extend(modules)

    def append(self, module: Module) -> "ModuleList":
        self.add_module(str(len(self)), module)
        return self

    def insert(self, index: int, module: Module) -> None:
        for i in range(len(self._modules), index, -1):
            self._modules[str(i)] = self._modules[str(i - 1)]
        self._modules[str(index)] = module

    def extend(self, modules: Iterable[Module]) -> "ModuleList":
        for module in modules:
            self.append(module)
        return self


class ModuleDict(Module):
    def __init__(self, modules: Optional[Dict[str, Module]] = None) -> None:
        super().__init__()
        if modules is not None:
            self.update(modules)

    def __getitem__(self, key: str) -> Module:
        return self._modules[key]

    def __setitem__(self, key: str, module: Module) -> None:
        self.add_module(key, module)

    def __delitem__(self, key: str) -> None:
        del self._modules[key]

    def __len__(self) -> int:
        return len(self._modules)

    def __iter__(self) -> Iterator[str]:
        return iter(self._modules)

    def __contains__(self, key: str) -> bool:
        return key in self._modules

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, modules: Dict[str, Module]) -> None:
        for key, module in modules.items():
            self[key] = module
