"""Decode the ANSI truecolor frame the program writes back to pixels.

A frame is the cursor-home prefix ESC[0;0H, then each row of W cells and
a newline; a cell is ESC[48;2;RRR;GGG;BBBm, two spaces, ESC[0m (25 bytes,
three decimal digits a channel; buffered_draw_screen,
TerminalRayTracer.c:1101-1172).
"""

from __future__ import annotations

import numpy as np

PREFIX = b"\033[0;0H"
CELL = np.frombuffer(b"\033[48;2;000;000;000m  \033[0m", np.uint8)
DIGITS = (7, 8, 9, 11, 12, 13, 15, 16, 17)
_FIXED = np.setdiff1d(np.arange(CELL.size), DIGITS)


class MalformedFrame(ValueError):
    """The bytes are not one ANSI frame of the expected size."""


def frame_size(width: int, height: int) -> int:
    return len(PREFIX) + height * (width * CELL.size + 1)


def decode(buf, width: int, height: int) -> np.ndarray:
    """The (H, W, 3) uint8 pixels of one frame; raises MalformedFrame on
    any byte out of the layout or a channel above 255."""
    a = np.frombuffer(bytes(buf) if not isinstance(buf, np.ndarray) else buf,
                      np.uint8)
    if a.size != frame_size(width, height):
        raise MalformedFrame(f"{a.size} bytes, expected "
                             f"{frame_size(width, height)}")
    if a[:len(PREFIX)].tobytes() != PREFIX:
        raise MalformedFrame("no cursor-home prefix")
    body = a[len(PREFIX):].reshape(height, width * CELL.size + 1)
    if (body[:, -1] != ord("\n")).any():
        raise MalformedFrame("a row does not end in a newline")
    cells = body[:, :-1].reshape(height, width, CELL.size)
    if (cells[..., _FIXED] != CELL[_FIXED]).any():
        raise MalformedFrame("a cell's escape bytes differ")
    d = cells[..., list(DIGITS)].astype(np.int32) - ord("0")
    if ((d < 0) | (d > 9)).any():
        raise MalformedFrame("a channel is not three decimal digits")
    d = d.reshape(height, width, 3, 3)
    rgb = d[..., 0] * 100 + d[..., 1] * 10 + d[..., 2]
    if (rgb > 255).any():
        raise MalformedFrame("a channel above 255")
    return rgb.astype(np.uint8)
