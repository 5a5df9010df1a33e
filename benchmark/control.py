"""The check's control: the reference in bfloat16, the precision below the
configuration's float32 (TF32 touches only matrix products, and the
renderer has none), put in the program's place where the program makes
its frames.

``Planted(app, cell, seed, device)`` wraps the program's four frame-step
builders for the life of a ``with`` block, as a fault would be planted.
Each step it builds returns, for the scene time it is given, the
reference's frame rendered in bfloat16 (in ``dtype`` if given: the
float32 plant is the judge itself and has to read correct), as the
compact (H, W, 3) uint8 frame the host encode takes, on the program's
device (a batch: (batch, H, W, 3) at the batched step's times). A physics
step's k-th call returns the reference's frame k (its world stepped k
frames in the control's dtype) as a float framebuffer that the loop's
quantization turns back into those u8 values, and the state it was given
unchanged. Entered before a run, it lies under the run's ``Recorder``: the loop copies, encodes and writes the control's
frames, and the run's check decodes them and judges them against the
float32 reference as it judges the program's, so the run's ``correct``
has to come out false.
"""

from __future__ import annotations

import torch

from benchmark import harness
from benchmark.reference.vec import Vec3

DTYPE = torch.bfloat16


def framebuffer(u8: torch.Tensor, dtype) -> Vec3:
    """(H, W, 3) uint8 -> a float (H, W) framebuffer that C's (int)(c *
    255) quantizes back to ``u8``: each level's middle, (v + 0.5) / 255."""
    c = (u8.to(dtype) + 0.5) / 255.0
    return Vec3(c[..., 0], c[..., 1], c[..., 2])


class Planted:
    BUILDERS = ("build_frame_step", "build_pathtrace_frame_step",
                "build_frame_batch_step", "build_physics_frame_step")

    def __init__(self, app, cell: dict, seed: int, device, dtype=DTYPE):
        self.app = app
        self.cell = cell
        self.seed = seed
        self.device = torch.device(device)
        self.dtype = dtype
        self._ref = None
        self._saved = {}

    def frame(self, t: float) -> torch.Tensor:
        """The reference's (H, W, 3) uint8 frame at ``t`` in the control's
        dtype."""
        if self._ref is None:
            self._ref = harness.reference(self.cell, self.device, self.dtype)
        u8, _ = harness.render_reference(self._ref, self.cell["config"], t,
                                         self.seed, None, self.dtype,
                                         self.device)
        return u8

    def _single(self, scene, cfg, encode, *args, **kw):
        if encode != "host":
            raise ValueError("the control serves the host encode")

        def frame_step(t, cam_offset):
            return self.frame(t)

        return frame_step

    def _batch(self, scene, cfg, batch, *args, **kw):
        step = torch.arange(batch, dtype=cfg.dtype) * torch.tensor(
            cfg.frame_duration, dtype=cfg.dtype)

        def batch_step(t0, cam_offset):
            times = torch.tensor(t0, dtype=cfg.dtype) + step
            return torch.stack([self.frame(t) for t in times.tolist()])

        return batch_step

    def _physics(self, scene, cfg, *args, **kw):
        made = 0

        def frame_step(state, cam_offset, count_rays=False):
            nonlocal made
            made += 1
            return (state, framebuffer(self.frame(made * cfg.frame_duration),
                                       cfg.dtype), None)

        return frame_step

    def __enter__(self):
        for name in self.BUILDERS:
            self._saved[name] = getattr(self.app, name)
        self.app.build_frame_step = self._single
        self.app.build_pathtrace_frame_step = self._single
        self.app.build_frame_batch_step = self._batch
        self.app.build_physics_frame_step = self._physics
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.app, name, fn)
        return False
