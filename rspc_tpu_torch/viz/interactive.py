"""Minimal interactive viewer: key-driven re-render over ViewState (port
of ``rspc_tpu/viz/interactive.py``).

The reference's ``--view`` opens a GLFW window with mouse-drag yaw/pitch,
scroll zoom, and space-to-reset (src/visualizer.hpp:24-53, main.cpp:
101-115). The card's host has no GL stack, so the interactive loop here
runs in the terminal instead:

  * arrow keys / hjkl  -> mouse-drag analog (ViewState.drag, same
    clamping: yaw [-120, 120], pitch [-80, 80])
  * +/- or =/_         -> scroll analog (ViewState.scroll)
  * space              -> reset (key 32, matching the reference's
    register_glfw_callbacks key handler)
  * q / Ctrl-C         -> quit
  * s                  -> save a full-resolution PNG next to the dataset

Each keypress re-renders through the same rasterizer the headless path
uses, on the device of the clouds, and repaints the terminal with 24-bit
ANSI half-block cells: a live view over SSH, no X required. Renders a
single PNG when stdin is not a TTY."""

from __future__ import annotations

import os
import sys

import numpy as np


def _ansi_preview(img: np.ndarray, cols: int = 100) -> str:
    """Render an RGB image as 24-bit ANSI half-block rows (2 pixels per
    character cell vertically)."""
    h, w = img.shape[:2]
    cols = min(cols, w)
    rows = max(int(cols * h / w / 2), 1) * 2
    ys = (np.arange(rows) * h / rows).astype(int)
    xs = (np.arange(cols) * w / cols).astype(int)
    small = img[ys][:, xs]
    out = []
    for r in range(0, rows - 1, 2):
        line = []
        for c in range(cols):
            tr, tg, tb = small[r, c]
            br, bg, bb = small[r + 1, c]
            line.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀"
            )
        out.append("".join(line) + "\x1b[0m")
    return "\n".join(out)


def _read_key(fd) -> str:
    """One keypress, decoding arrow-key escape sequences."""
    ch = os.read(fd, 1).decode(errors="ignore")
    if ch == "\x1b":
        seq = os.read(fd, 2).decode(errors="ignore")
        return {"[A": "up", "[B": "down", "[C": "right", "[D": "left"}.get(
            seq, "esc"
        )
    return ch


def interactive_view(
    clouds,
    png_path: str | None = None,
    width: int = 1280,
    height: int = 720,
    preview_cols: int = 100,
    out=sys.stdout,
) -> None:
    """Run the interactive loop (blocking until q/Ctrl-C). Non-TTY stdin
    renders one PNG and returns, preserving the headless contract."""
    from rspc_tpu_torch.viz.render import ViewState, render_to_png

    state = ViewState()

    if not sys.stdin.isatty():
        if png_path:
            render_to_png(png_path, clouds, state, width, height)
        return

    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    step = 8.0  # degrees per keypress, a mouse-drag increment
    try:
        tty.setcbreak(fd)
        while True:
            img = render_to_png(
                png_path or os.devnull, clouds, state, width, height
            )
            out.write("\x1b[2J\x1b[H")  # clear + home
            out.write(_ansi_preview(img, preview_cols))
            out.write(
                f"\nyaw {state.yaw:+.0f}  pitch {state.pitch:+.0f}  "
                f"zoom {state.offset_y:+.1f}   "
                "[arrows/hjkl drag, +/- zoom, space reset, s save, q quit]\n"
            )
            out.flush()
            k = _read_key(fd)
            if k in ("q", "\x03", "\x04"):
                break
            elif k in ("left", "h"):
                state.drag(-step, 0)
            elif k in ("right", "l"):
                state.drag(step, 0)
            elif k in ("up", "k"):
                state.drag(0, -step)
            elif k in ("down", "j"):
                state.drag(0, step)
            elif k in ("+", "="):
                state.scroll(0, 1)
            elif k in ("-", "_"):
                state.scroll(0, -1)
            elif k == " ":
                state.reset()  # key 32 (visualizer.hpp:49-52)
            elif k == "s" and png_path:
                render_to_png(png_path, clouds, state, width, height)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
