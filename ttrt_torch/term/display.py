"""Host terminal control: frame output, cursor state, keyboard input (port
of ``ttrt.term.display``).

The host's per-frame jobs are one device->host copy, the ANSI expansion
of a compact RGB frame when the encode runs on the host (``native``), and
one write(2); the render, and with ``--encode device`` the ANSI encode,
happen on the device (encoder.py).

Covers the reference's terminal-facing behaviors:
  - single-write frame emission (buffered_draw_screen,
    TerminalRayTracer.c:1141-1172),
  - clean SIGINT shutdown restoring terminal state
    (TerminalRayTracer.c:1224-1232, 1247, 1369),
  - the fps HUD line at the top-left (TerminalRayTracer.c:1362-1365),
  - arrow-key camera movement — implemented; the reference only carries a
    commented-out stub (TerminalRayTracer.c:1196-1215).
"""

from __future__ import annotations

import os
import select
import signal
import sys
from typing import Optional

import numpy as np

from ttrt_torch.term.encoder import encode_ansi_host

HIDE_CURSOR = b"\033[?25l"
SHOW_CURSOR = b"\033[?25h"
RESET_ATTRS = b"\033[0m"
CURSOR_HOME = b"\033[0;0H"


class SigintFlag:
    """Volatile-flag SIGINT handling (TerminalRayTracer.c:1224-1232): mark
    and keep running so the frame loop can exit cleanly."""

    def __init__(self):
        self.received = False
        self._prev = None

    def __enter__(self):
        self._prev = signal.signal(signal.SIGINT, self._handler)
        return self

    def _handler(self, signum, frame):
        self.received = True

    def __exit__(self, *exc):
        if self._prev is not None:
            signal.signal(signal.SIGINT, self._prev)
        return False


class TerminalDisplay:
    """Context manager owning terminal state for the animation loop."""

    def __init__(self, stream=None, hide_cursor: bool = True):
        self.stream = stream if stream is not None else sys.stdout.buffer
        self.hide_cursor = hide_cursor

    def __enter__(self):
        if self.hide_cursor:
            self.stream.write(HIDE_CURSOR)
            self.stream.flush()
        return self

    def __exit__(self, *exc):
        self.stream.write(RESET_ATTRS)
        if self.hide_cursor:
            self.stream.write(SHOW_CURSOR)
        self.stream.write(b"\n")
        self.stream.flush()
        return False

    def write_frame(self, buf) -> int:
        """Emit one pre-encoded ANSI frame buffer (device array, NumPy array,
        or bytes) in a single write."""
        if not isinstance(buf, (bytes, bytearray, memoryview)):
            buf = np.asarray(buf).tobytes()
        n = self.stream.write(buf)
        self.stream.flush()
        return n

    def write_rgb_frame(self, rgb: np.ndarray) -> int:
        """Encode a compact (H, W, 3) uint8 frame on the host, then write it
        (the NumPy encoder; the animation loop uses the native one)."""
        return self.write_frame(encode_ansi_host(np.asarray(rgb)))

    def write_fps(self, fps: float) -> None:
        """Top-left fps HUD (TerminalRayTracer.c:1362-1365)."""
        self.stream.write(
            CURSOR_HOME + (b"%.02f fps\n" % fps) + CURSOR_HOME
        )
        self.stream.flush()


def draw_screen_naive(fb_rgb: np.ndarray, stream=None) -> None:
    """Per-pixel printf variant (draw_screen, TerminalRayTracer.c:1083-1099);
    debugging aid only."""
    stream = stream if stream is not None else sys.stdout.buffer
    stream.write(CURSOR_HOME)
    for row in fb_rgb:
        for r, g, b in row:
            stream.write(b"\033[48;2;%d;%d;%dm  \033[0m" % (r, g, b))
        stream.write(b"\n")
    stream.flush()


def print_ppm(image_u8: np.ndarray, stream=None) -> None:
    """Dump a texture to the terminal (print_ppm,
    TerminalRayTracer.c:1174-1194)."""
    draw_screen_naive(np.asarray(image_u8, np.uint8), stream)


class KeyboardInput:
    """Non-blocking raw-mode arrow-key reader for interactive camera moves
    (the reference's aspirational get_camera_movement,
    TerminalRayTracer.c:1196-1215). No-ops gracefully when stdin is not a
    tty (pipes, CI)."""

    ARROWS = {b"A": "up", b"B": "down", b"C": "right", b"D": "left"}

    def __init__(self):
        self._fd = None
        self._saved = None

    def __enter__(self):
        try:
            import termios
            import tty

            if sys.stdin.isatty():
                self._fd = sys.stdin.fileno()
                self._saved = termios.tcgetattr(self._fd)
                tty.setcbreak(self._fd)
        except Exception:
            self._fd = None
        return self

    def __exit__(self, *exc):
        if self._fd is not None and self._saved is not None:
            import termios

            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)
        return False

    def poll(self) -> Optional[str]:
        """Return 'up'/'down'/'left'/'right'/'quit' or a single char, else
        None. Never blocks."""
        if self._fd is None:
            return None
        r, _, _ = select.select([sys.stdin], [], [], 0)
        if not r:
            return None
        ch = os.read(self._fd, 1)
        if ch == b"\x1b":  # possible escape sequence
            r, _, _ = select.select([sys.stdin], [], [], 0)
            if r and os.read(self._fd, 1) == b"[":
                r, _, _ = select.select([sys.stdin], [], [], 0)
                if r:
                    return self.ARROWS.get(os.read(self._fd, 1))
            return None
        if ch in (b"q", b"\x03"):
            return "quit"
        return ch.decode("latin1")
