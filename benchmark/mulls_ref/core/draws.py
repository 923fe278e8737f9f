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

:class:`StackedDraws` serves S sequences stepped as one batch
(``parallel/multiseq.py``): each sequence keeps its own stream, and a draw
of shape ``[S, ...]`` stacks each sequence's own draw of ``[...]``, so a
sequence sees the numbers it would see alone.
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


class StackedDraws:
    """The draws of S sequences stepped as one batch: ``draws[s]`` is
    sequence s's own stream.  ``uniform`` and ``bits`` take the batched
    shape ``[S, ...]`` and stack each stream's draw of ``[...]``."""

    def __init__(self, draws: Sequence[Draws]):
        self.draws = list(draws)

    def split(self, n: int) -> List["StackedDraws"]:
        kids = [d.split(n) for d in self.draws]
        return [StackedDraws([k[i] for k in kids]) for i in range(n)]

    def _each(self, shape) -> tuple:
        shape = tuple(shape)
        if not shape or shape[0] != len(self.draws):
            raise ValueError(f"a draw of {len(self.draws)} stacked streams "
                             f"needs a shape [{len(self.draws)}, ...], got "
                             f"{list(shape)}")
        return shape[1:]

    def uniform(self, shape) -> torch.Tensor:
        each = self._each(shape)
        return torch.stack([d.uniform(each) for d in self.draws])

    def bits(self, shape) -> torch.Tensor:
        each = self._each(shape)
        return torch.stack([d.bits(each) for d in self.draws])

    def get_state(self):
        return [d.get_state() for d in self.draws]

    def set_state(self, state) -> None:
        for d, st in zip(self.draws, state):
            d.set_state(st)
