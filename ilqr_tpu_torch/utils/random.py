"""Normal draws for the sampling modules (`mppi`, `estimation`) and
`ilqg.simulate_closed_loop`.

JAX draws from explicit keys; the port draws from explicit
`torch.Generator`s, in the order JAX splits its keys.  Every draw goes
through `normal`, looked up at call time, so a test can stand in JAX's own
draws for the port's.
"""
from __future__ import annotations

import torch


def generator(seed_or_generator, device) -> torch.Generator:
    """A `torch.Generator` on ``device``: the one given, or a new one
    seeded with the given int."""
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    g = torch.Generator(device=device)
    g.manual_seed(int(seed_or_generator))
    return g


def normal(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """Standard normal draws of ``shape`` from ``gen``."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)
