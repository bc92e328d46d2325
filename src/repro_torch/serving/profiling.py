"""The engine's hooks into torch for ``repro_torch.obs``, which imports
only the standard library.

* The profiler: on import, ``obs`` learns to read torch's own "a profile
  is active" flag (``torch.autograd.profiler._is_profiler_enabled``, set
  while any ``torch.profiler`` session runs) and to enter
  ``record_function`` ranges then, so the engine's spans and the MoE
  layer's ``moe.sorted`` sit in a profile on the kernels' clock.
* The card's clock (:class:`CudaClock`): what a traced engine's tracer
  records its device spans with — a timing event on the current stream
  at each end, put on the tracer's host clock by one anchor event.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from repro_torch.obs import install_profiler

install_profiler(_autograd_profiler, torch.profiler.record_function)


class CudaClock:
    """Stream events on the host clock, for ``Tracer(device_clock=...)``.

    ``anchor`` pairs one event, recorded on an idle card, with a reading of
    the tracer's clock; an event's host time is then the anchor's plus the
    card's elapsed time between the two.  ``done`` only queries: nothing
    here waits except ``anchor`` and ``synchronize`` (the tracer's reset
    and export)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._anchor: Optional[torch.cuda.Event] = None
        self._anchor_host = 0.0

    def anchor(self, clock: Callable[[], float]) -> None:
        torch.cuda.synchronize(self.device)
        ev = self.record()
        ev.synchronize()
        self._anchor, self._anchor_host = ev, clock()

    def record(self) -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    @staticmethod
    def done(ev: torch.cuda.Event) -> bool:
        return ev.query()

    def seconds(self, ev: torch.cuda.Event) -> float:
        """Host time of a completed event (the tracer's clock)."""
        return self._anchor_host + self._anchor.elapsed_time(ev) / 1e3

    def synchronize(self) -> None:
        torch.cuda.synchronize(self.device)


def device_clock(device: torch.device) -> Optional[CudaClock]:
    """The device clock of a traced engine on ``device``: none on the CPU,
    whose device spans are host spans only."""
    return CudaClock(device) if device.type == "cuda" else None
