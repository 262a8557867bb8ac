"""Where the port runs: one CUDA card unless the caller names the CPU.

Every entry point takes a ``device`` argument and passes it through
``resolve``. With none given it is ``cuda:0``; a machine without a card
is an error, never a quiet move to the CPU (the CPU runs the kernels'
plain versions, which is what tests ask for by name). ``"meta"``, asked
for by name, is the dry run's (``launch/dryrun.py``): shapes and no
storage, nothing launched; ``generator`` there draws nothing.

``LAUNCHES`` is the process's launch gate: the search engine's device
work holds it shared, a profiler session's start and stop hold it alone.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda:0``; a name or ``torch.device`` as given: a
    card, the CPU, or the meta device (by name only).

    Raises ``RuntimeError`` when a CUDA device is asked for (or implied)
    and none is present."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"device must be 'cuda', 'cpu' or 'meta', got {dev}")
    return dev


class NoDraw:
    """A random generator's stand-in on the meta device, whose tensors
    hold no numbers: the init functions read its ``device`` and draw
    nothing (``draws``)."""

    device = torch.device("meta")


def generator(device: DeviceLike, seed: int):
    """A ``torch.Generator`` on ``resolve(device)`` seeded with ``seed``;
    on the meta device a ``NoDraw``."""
    dev = resolve(device)
    if dev.type == "meta":
        return NoDraw()
    return torch.Generator(device=dev).manual_seed(seed)


def draws(gen) -> bool:
    """Whether ``gen`` draws numbers (not on the meta device)."""
    return gen.device.type != "meta"


class LaunchGate:
    """Who may put work on the card right now.

    Every thread that launches device work for the search engine holds
    the gate shared (``launching``; the engine's searches and uploads do,
    re-entrantly); a profiler session's start and stop hold it alone
    (``quiesced``): no shared holder is inside, none may enter, and the
    card has finished what was enqueued. On the card's torch 2.11 with
    CUDA 12.8, a ``torch.profiler`` session started or stopped while
    other threads launch kernels records no kernel in about one capture
    of four to eight, and often none in the captures after it (ROADMAP
    C16; ``benchmarks/port_profile_threads.py`` counts them)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._inside = 0                 # shared holders
        self._closing = False            # an exclusive holder waits or holds
        self._exclusive = threading.Lock()
        self._depth = threading.local()  # this thread's shared depth

    @contextlib.contextmanager
    def launching(self):
        depth = getattr(self._depth, "n", 0)
        if depth == 0:                   # a nested call never waits
            with self._cond:
                while self._closing:
                    self._cond.wait()
                self._inside += 1
        self._depth.n = depth + 1
        try:
            yield
        finally:
            self._depth.n = depth
            if depth == 0:
                with self._cond:
                    self._inside -= 1
                    if not self._inside:
                        self._cond.notify_all()

    @contextlib.contextmanager
    def quiesced(self, device: DeviceLike = None):
        """Hold the gate alone, with ``device``'s queue drained when it is
        a card. Not re-entrant, and not for a thread inside
        ``launching``."""
        with self._exclusive:
            with self._cond:
                self._closing = True
                while self._inside:
                    self._cond.wait()
            try:
                if device is not None and torch.device(device).type == "cuda":
                    torch.cuda.synchronize(device)
                yield
            finally:
                with self._cond:
                    self._closing = False
                    self._cond.notify_all()


# the process's one gate: CUPTI's state, which it guards, is process-wide
LAUNCHES = LaunchGate()
