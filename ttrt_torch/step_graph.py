"""Frame steps replayed as CUDA graphs.

A frame step on the card issues about 130 small device ops around one
render launch: the orbit pose, the scene pack, the launch, the trace-count
sum where the wrapper makes one, and the quantize or the device ANSI
encode. Issued one by one from Python, they take the host milliseconds
that a 0.12-ms kernel does not. ``GraphedStep`` runs a step's body once
eagerly, captures it into a ``torch.cuda.CUDAGraph``, and from then on
replays the graph: the same kernels on the same inputs, so every frame
keeps its bits. The scene time and the camera offset are the graph's
static inputs, written before each replay.

``engages`` is the rule: a step is graphed when nothing in it needs the
host between its ops and every op is captured: its route says so
(``routes.Route.graphable``) and its device is a CUDA device.
"""

from __future__ import annotations

import torch

from ttrt_torch.utils.profiling import LAUNCHERS, STEPS, span


def engages(device, route, debug_nans: bool = False) -> bool:
    """Whether a frame step on ``device`` through ``route`` (a
    ``routes.Route``) is graphed: the device is a CUDA device, the route
    is ``graphable``, and ``debug_nans`` is off (its check reads the
    framebuffer on the host)."""
    return (torch.device(device).type == "cuda" and route.graphable
            and not debug_nans)


def eager(step, device):
    """``step``, each call counted in ``STEPS.eager`` on a CUDA device;
    on the CPU the step itself."""
    if torch.device(device).type != "cuda":
        return step

    def counted(t, cam_offset):
        STEPS.eager += 1
        return step(t, cam_offset)

    return counted


class GraphedStep:
    """(t, cam_offset) -> ``body``'s result, from a CUDA graph of ``body``.

    ``body(t, cam_offset)`` takes the scene time as a 0-dim tensor and the
    camera offset as a (3,) tensor, both in ``dtype`` on ``device``, and
    does only device work on them. The first call writes its inputs into
    the static ones, runs ``body`` eagerly on them (loading the kernel
    library, choosing the launch shapes, warming the allocator) and
    returns that result; then it captures ``body`` on the same inputs.
    Every later call writes ``float(t)`` in ``dtype`` and the offset into
    the static inputs, replays the graph and returns a device copy of its
    output, so a frame still in flight (``--pipeline``, the batched loop)
    is not overwritten by the next replay. All of it runs on the current
    stream. A replay opens the span ``launch`` around the writes, the
    replay and the copy, and adds the graph's launches to the
    ``launches`` of each ``profiling.counted`` wrapper it holds."""

    def __init__(self, body, dtype: torch.dtype, device):
        self.body = body
        self.device = torch.device(device)
        self.t = torch.zeros((), dtype=dtype, device=self.device)
        self.offset = torch.zeros(3, dtype=dtype, device=self.device)
        self.graph = None
        self.out = None
        self.launches = ()  # (wrapper, its launches a replay)

    def _write(self, t, cam_offset) -> None:
        self.t.fill_(t)
        self.offset.copy_(cam_offset)

    def __call__(self, t, cam_offset):
        if self.graph is None:
            return self._first(t, cam_offset)
        with span("launch"):
            self._write(t, cam_offset)
            self.graph.replay()
            out = self.out.clone()
        for fn, n in self.launches:
            fn.launches += n
        STEPS.replayed += 1
        return out

    def _first(self, t, cam_offset):
        self._write(t, cam_offset)
        out = self.body(self.t, self.offset)
        STEPS.eager += 1
        before = {fn: fn.launches for fn in LAUNCHERS}
        graph = torch.cuda.CUDAGraph()
        # thread_local: the loops' copy threads may call the runtime
        with torch.cuda.device(self.device), torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            self.out = self.body(self.t, self.offset)
        # the capture ran the wrappers' Python but launched nothing
        self.launches = tuple((fn, fn.launches - n)
                              for fn, n in before.items()
                              if fn.launches != n)
        for fn, n in self.launches:
            fn.launches -= n
        self.graph = graph
        return out
