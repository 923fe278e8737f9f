"""What the timed path produced, kept for the comparison by reference (no
device work):

* :class:`KernelProbe`: after each segment boundary, the first call into
  each of the program's kernel wrappers (``nn_grouped``, ``moments``,
  ``pca_moments``), inputs and outputs, so that the comparison can run the
  plain versions on the very inputs of that call, for every sequence of the
  batch;
* :class:`StageProbe`: at the frames drawn for the comparison, the step's
  inputs and outputs (state, features, answers, the draws' positions).

Both wrap module attributes that the program looks up at each call
(``ops.kernels``' wrappers, ``parallel.multiseq.slam_step``,
``pipeline.odometry.extract_features`` and ``update_local_map``), so
wrapping them reaches every caller."""

from __future__ import annotations

from typing import Dict, Optional

NAMES = ("nn_grouped", "moments", "pca_moments")


class KernelProbe:
    def __init__(self, module, names=NAMES):
        self.module = module
        self.calls: Dict[int, dict] = {}
        self.at: Optional[int] = None
        self.armed: set = set()
        self._orig = {}
        for name in names:
            fn = getattr(module, name)
            self._orig[name] = fn
            setattr(module, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            if name in self.armed:
                self.armed.discard(name)
                self.calls[self.at][name] = (args, kw, out)
            return out
        wrapped.__name__ = fn.__name__
        wrapped.__doc__ = fn.__doc__
        if hasattr(fn, "launches"):
            wrapped.launches = fn.launches
        return wrapped

    def arm(self, boundary: int) -> None:
        """Keep the first call of each kernel from here on, under
        ``boundary`` (the frames done)."""
        self.at = boundary
        self.calls[boundary] = {}
        self.armed = set(self._orig)

    def restore(self) -> None:
        for name, fn in self._orig.items():
            setattr(self.module, name, fn)


def _draw_states(draws) -> list:
    """Each stream's generator state (host copies; no device work)."""
    if hasattr(draws, "draws"):  # the batch's stacked streams
        return [d.get_state() for d in draws.draws]
    return [draws.get_state()]


class StageProbe:
    """The stages' inputs and outputs on the timed path, for the frames in
    ``frames``: the step (``step_module.slam_step``) is wrapped to keep the
    state it is handed and the state and answers it returns, and the
    feature extraction that the step looks up in ``stage_module`` is
    wrapped to keep its output, all by reference (no device work).  The
    draws' stream positions at the step's start and at the map insertion
    (``stage_module.update_local_map``) are read from the benchmark's own
    generators.  ``kept[frame]``: ``state_in``, ``state_out``, ``out``,
    ``feats``, ``draws_step``, ``draws_map``."""

    def __init__(self, step_module, stage_module, frames):
        self.frames = set(int(f) for f in frames)
        self.kept: Dict[int, dict] = {}
        self._at: Optional[dict] = None
        self._orig = [(step_module, "slam_step"),
                      (stage_module, "extract_features"),
                      (stage_module, "update_local_map")]
        self._fns = {(m, n): getattr(m, n) for m, n in self._orig}
        step = self._fns[(step_module, "slam_step")]
        extract = self._fns[(stage_module, "extract_features")]
        insert = self._fns[(stage_module, "update_local_map")]

        def slam_step(state, raw, cfg, *a, frame=None, **kw):
            if frame is None or int(frame) not in self.frames:
                return step(state, raw, cfg, *a, frame=frame, **kw)
            rec = {"state_in": state, "draws_step": _draw_states(state.draws)}
            self._at = rec
            try:
                res = step(state, raw, cfg, *a, frame=frame, **kw)
            finally:
                self._at = None
            rec.update(state_out=res[0], out=res[1])
            self.kept[int(frame)] = rec
            return res

        def extract_features(*a, **kw):
            out = extract(*a, **kw)
            if self._at is not None and "feats" not in self._at:
                self._at["feats"] = out
            return out

        def update_local_map(local_map, frame, T_rel, dyn, mcfg, draws,
                             *a, **kw):
            rec = self._at
            if rec is not None and "draws_map" not in rec:
                rec["draws_map"] = _draw_states(draws)
            return insert(local_map, frame, T_rel, dyn, mcfg, draws, *a,
                          **kw)

        for (m, n), fn in zip(self._orig, (slam_step, extract_features,
                                           update_local_map)):
            setattr(m, n, fn)

    def restore(self) -> None:
        for (m, n) in self._orig:
            setattr(m, n, self._fns[(m, n)])
