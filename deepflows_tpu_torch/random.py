"""Package random generators (counterpart of ``deepflows_tpu/random.py``).

The JAX package splits keys off one process-global key.  Here each device
has one package ``torch.Generator``; parameter init and dropout draw from
it and never from torch's global generator.  ``manual_seed`` reseeds every
device's generator.  A CPU and a CUDA generator give different numbers from
one seed, as JAX's and torch's do: parity tests copy weights across
(``utils.convert.load_jax_state_dict``) and never rest on seeds.
"""

from __future__ import annotations

import torch

from .config import config

_generators: dict = {}


def manual_seed(seed: int) -> None:
    """Reseed every package generator; under lazy mode the draws already
    recorded run first, from the old state."""
    from .backend import lazy

    if lazy.recording():
        lazy.flush()
    config.seed = int(seed)
    _generators.clear()


def generator(device) -> torch.Generator:
    """The package generator of ``device``, seeded with ``config.seed`` when
    first used."""
    device = torch.device(getattr(device, "torch_device", device))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    g = _generators.get(device)
    if g is None:
        g = torch.Generator(device=device)
        g.manual_seed(config.seed)
        _generators[device] = g
    return g
