"""ANSI truecolor frame encoding on the device (port of
``ttrt.term.encoder``).

The reference's fast output path (TerminalRayTracer.c:1101-1172) patches
the decimal digit fields of one big ANSI template per frame and emits one
fwrite. Here the whole encode is elementwise tensor code on the frame's
device:

  float framebuffer -> *255 int truncation -> per-channel decimal digits
  (TerminalRayTracer.c:1133-1139) -> digit columns of a constant byte
  template -> ONE uint8 buffer,

so the host does one device-to-host copy and one write(2).

Byte layout per pixel (pixel_str, TerminalRayTracer.c:1103):
    \\033[48;2;RRR;GGG;BBBm  \\033[0m   (25 bytes)
offsets: R digits at 7..9, G at 11..13, B at 15..17. Each row of W pixels
ends with \\n; the frame starts with the cursor-home prefix \\033[0;0H
(reset_str, TerminalRayTracer.c:1102).
"""

from __future__ import annotations

import numpy as np
import torch

from ttrt_torch.vec import Vec3

RESET_STR = b"\033[0;0H"
PIXEL_TEMPLATE = np.frombuffer(b"\033[48;2;000;000;000m  \033[0m", np.uint8)
PIXEL_BYTES = PIXEL_TEMPLATE.size  # 25
_R_OFF, _G_OFF, _B_OFF = 7, 11, 15
_ZERO = ord("0")


def quantize_channel(c: torch.Tensor) -> torch.Tensor:
    """float [0,1] -> int32 0..255 via C's (int)(x*255) truncation
    (TerminalRayTracer.c:1157-1163)."""
    return (c * 255.0).to(torch.int32)


def ansi_template(width: int, height: int, device) -> torch.Tensor:
    """The ANSI buffer of an all-black frame on ``device``: the constant
    bytes every encoded frame shares. Build it once per resolution; each
    frame then writes only its digit columns, with no host-to-device copy."""
    black = encode_ansi_host(np.zeros((height, width, 3), np.uint8))
    return torch.as_tensor(np.frombuffer(black, np.uint8).copy(),
                           device=device)


def encode_ansi_frame(fb: Vec3, template: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """(H, W) float framebuffer -> flat uint8 ANSI byte buffer on the
    framebuffer's device, of length ansi_buffer_size(W, H). ``template`` is
    ``ansi_template(W, H, device)``, built here when not given."""
    H, W = fb.x.shape
    if template is None:
        template = ansi_template(W, H, fb.x.device)
    out = template.clone()
    cells = out[len(RESET_STR):].view(H, W * PIXEL_BYTES + 1)
    cells = cells[:, :W * PIXEL_BYTES].view(H, W, PIXEL_BYTES)
    for off, c in ((_R_OFF, fb.x), (_G_OFF, fb.y), (_B_OFF, fb.z)):
        v = quantize_channel(c)
        cells[:, :, off] = (v // 100 + _ZERO).to(torch.uint8)
        cells[:, :, off + 1] = ((v // 10) % 10 + _ZERO).to(torch.uint8)
        cells[:, :, off + 2] = (v % 10 + _ZERO).to(torch.uint8)
    return out


def encode_rgb_frame(fb: Vec3) -> torch.Tensor:
    """(H, W) float framebuffer -> (H, W, 3) uint8 on its device: the
    compact wire format when the ANSI expansion happens on the host."""
    return torch.stack(
        [quantize_channel(c).to(torch.uint8) for c in (fb.x, fb.y, fb.z)],
        dim=-1,
    )


def ansi_buffer_size(width: int, height: int) -> int:
    return len(RESET_STR) + height * (width * PIXEL_BYTES + 1)


def encode_ansi_host(rgb: np.ndarray) -> bytes:
    """Host/numpy encoder: (H, W, 3) uint8 -> ANSI bytes. The oracle for
    the device encoder and the expansion for compact-RGB frames."""
    H, W, _ = rgb.shape
    body = np.broadcast_to(PIXEL_TEMPLATE, (H * W, PIXEL_BYTES)).copy()
    flat = rgb.reshape(-1, 3).astype(np.int32)
    for off, v in ((_R_OFF, flat[:, 0]), (_G_OFF, flat[:, 1]),
                   (_B_OFF, flat[:, 2])):
        body[:, off] = v // 100 + _ZERO
        body[:, off + 1] = (v // 10) % 10 + _ZERO
        body[:, off + 2] = v % 10 + _ZERO
    rows = body.reshape(H, W * PIXEL_BYTES)
    out = np.concatenate(
        [rows, np.full((H, 1), ord("\n"), np.uint8)], axis=1
    )
    return RESET_STR + out.tobytes()
