"""Device resolution for the port's entry points, and the device timer of
traced spans.

Every entry point that places tensors (``TesseraeScheduler``,
``MatchContext``, ``solve_lap_batched``, ``plan_migration``) takes an
explicit ``device``.  ``None`` means the card: the port runs on CUDA unless
the caller asks for the CPU (the CPU tests pass ``device="cpu"``).  There is
no silent fallback — asking for CUDA on a host without it raises.

:func:`device_timer` gives a traced span (``repro_torch.obs``) the device
time of the work it launches.
"""

from __future__ import annotations

import torch

from repro_torch.obs.tracer import Span


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: a CUDA device was requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU explicitly"
        )
    return dev


#: event pairs of finished timers, by CUDA device index, for the next ones
_IDLE_PAIRS: dict = {}


def _event_pair(device: torch.device):
    """A timing event pair on ``device``: an idle one, or a new one made
    ready here (a first record creates a CUDA event), so no event is
    created inside the launch it times."""
    idle = _IDLE_PAIRS.setdefault(device.index, [])
    if idle:
        return idle.pop()
    pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    with torch.cuda.device(device):
        for ev in pair:
            ev.record()
    return pair


class _DeviceTimer:
    """A CUDA event pair on the current stream around a span's launch."""

    __slots__ = ("_span", "_device", "_pair", "_handed")

    def __init__(self, span, device: torch.device):
        self._span = span
        self._device = device
        self._pair = _event_pair(device)
        self._handed = False

    def __enter__(self) -> "_DeviceTimer":
        return self

    def handles(self):
        """The raw ``cudaEvent_t`` pair for a C entry point to record on its
        stream right before and right after its kernel launch."""
        self._handed = True
        return self._pair[0].cuda_event, self._pair[1].cuda_event

    def __exit__(self, exc_type, exc, tb) -> None:
        # after the readout the end event is complete; where it is not (no
        # readout followed), the span keeps no device time: never wait here
        start, end = self._pair
        if self._handed and exc_type is None and end.query():
            self._span.device_s = start.elapsed_time(end) * 1e-3
        _IDLE_PAIRS[self._device.index].append(self._pair)


class _NoTimer:
    __slots__ = ()

    def __enter__(self) -> "_NoTimer":
        return self

    def handles(self):
        return None, None

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


#: the timer that records nothing: tracing off, the CPU, or no span
NO_TIMER = _NoTimer()


def device_timer(span, device):
    """Time, on the device, the launch a traced span makes.

    Use as::

        with device_timer(span, dev) as timer:
            out = wrapper(..., timer=timer)       # uploads, plan, launch
            host = out.cpu()                      # the readout already there

    where the launch wrapper hands ``timer.handles()`` to its C entry
    point, which records the pair of CUDA events on the current stream
    right before and right after its kernel launch.  So the pair holds the
    kernel's device time, not the wrapper's host time or the gaps in which
    the device waits for the host between the span's smaller operations.
    The events are made ready outside the launch and reused by later
    timers.  On exit, after the readout the code already makes,
    ``span.device_s`` gets the time between the two events (seconds) if
    the end event is complete.  It adds no synchronisation, no readout and
    no decision input.  Only a real ``Span`` on a CUDA device gets events;
    with tracing off (a null span), on the CPU or without a span the timer
    is :data:`NO_TIMER`, which creates nothing and does nothing.
    """
    if isinstance(span, Span) and device is not None:
        device = torch.device(device)
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            return _DeviceTimer(span, device)
    return NO_TIMER
