"""The phases of a measured window. An untraced run has one, ``plain``.
A traced run has ``plain`` for ``seconds - profiled_s``, then each
profiler in turn for an equal share of ``profiled_s``, each begun after
the device has caught up and timed from its own start: ``device`` (CUDA
activity alone, which costs the host almost nothing: busy time, idle
share, top kernels) and ``host`` (host and CUDA activity: the spans'
kernels and what the host did in the idle gaps)."""

from __future__ import annotations

import time

from torch.profiler import record_function

WINDOW_SPAN = "h100bench.window"


class Phases:
    def __init__(self, seconds: float, profiled_s: float, factories, sync):
        """``factories``: ``(name, make, finish)`` of each profiled phase;
        ``finish(profiler)`` reads a stopped profiler before the next one
        starts (a later session's start clears what an earlier one kept)."""
        self.plan = [("plain", seconds - profiled_s if profiled_s > 0 else seconds, None, None)]
        if profiled_s > 0:
            self.plan += [(name, profiled_s / len(factories), make, finish)
                          for name, make, finish in factories]
        self.sync = sync
        self.index = 0
        self.t_phase = time.perf_counter()
        self.profilers = {}
        self._open = None

    @property
    def length(self) -> float:
        return self.plan[self.index][1]

    def over(self, t: float) -> bool:
        """Whether a request at time ``t`` falls past the current phase."""
        return t - self.t_phase >= self.length

    def advance(self) -> bool:
        """Close the current phase and open the next; False after the last."""
        self.sync()
        if self._open is not None:
            prof, span = self._open
            span.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            name, _, _, finish = self.plan[self.index]
            self.profilers[name] = finish(prof)
            self._open = None
        self.index += 1
        if self.index == len(self.plan):
            return False
        prof = self.plan[self.index][2]()
        prof.__enter__()
        span = record_function(WINDOW_SPAN)
        span.__enter__()
        self._open = (prof, span)
        self.t_phase = time.perf_counter()
        return True
