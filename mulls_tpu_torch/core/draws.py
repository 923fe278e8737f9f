"""Random draws behind one small interface.

The reference threads ``jax.random`` keys through the step
(`pipeline/odometry.py:665`, `frontend/features.py:52`,
`ops/ground.py:126`) and draws at `core/cloud.py:247`,
`ops/ground.py:137,242,251`, `ops/voxel.py:109,120,135` and
`mapping/local_map.py:144`.  The port keeps the same tree shape: every
function that takes a key there takes a :class:`Draws` here, splits it the
same way and draws the same shapes.  Production draws come from one
``torch.Generator`` seeded from ``cfg.seed``; a test can supply an
implementation that replays the JAX key tree so that both packages see the
same numbers.
"""

from __future__ import annotations

from typing import List, Protocol, Sequence

import torch


class Draws(Protocol):
    def split(self, n: int) -> List["Draws"]:
        """``n`` child streams (``jax.random.split`` parity)."""

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        """float32 uniforms in [0, 1) of ``shape``."""

    def bits(self, shape: Sequence[int]) -> torch.Tensor:
        """Uniform 32-bit words of ``shape``, held in int64."""

    def get_state(self):
        """A picklable snapshot of the stream (for checkpoints)."""

    def set_state(self, state) -> None:
        """Continue from a :meth:`get_state` snapshot."""


class GeneratorDraws:
    """Production draws: one ``torch.Generator`` on the run's device.
    Children share the generator, so successive draws are independent."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def split(self, n: int) -> List["GeneratorDraws"]:
        return [self] * n

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.gen,
                          device=self.device, dtype=torch.float32)

    def bits(self, shape) -> torch.Tensor:
        return torch.randint(0, 1 << 32, tuple(shape), generator=self.gen,
                             device=self.device, dtype=torch.int64)

    def get_state(self):
        """The generator's state (a checkpoint stores it)."""
        return self.gen.get_state().numpy()

    def set_state(self, state) -> None:
        self.gen.set_state(torch.as_tensor(state, dtype=torch.uint8))
