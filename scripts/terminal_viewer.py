"""Interactive terminal viewer: fly the demo scene with WASD + arrow keys.

The reference opens a GLFW window (src/window/gl_window.rs); this engine
renders offscreen, so the interactive path is a host loop feeding keys into
the InputState and painting frames as ANSI half-block characters — a
dependency-free "window". Run in any truecolor terminal:

    python scripts/terminal_viewer.py [--width 160] [--height 88]

Controls: w/a/s/d thrust, space/c up/down, arrow keys look, q quits.
Requires a TTY; exits with a note when stdin is not interactive.
"""

import argparse
import os
import select
import sys
import termios
import time
import tty

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def paint(rgb: np.ndarray) -> str:
    """(H, W, 3) uint8 -> ANSI half-block string (two rows per char)."""
    h, w = rgb.shape[:2]
    out = ["\x1b[H"]
    for y in range(0, h - 1, 2):
        row = []
        for x in range(w):
            tr, tg, tb = rgb[y, x]
            br, bg, bb = rgb[y + 1, x]
            row.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀"
            )
        out.append("".join(row) + "\x1b[0m\n")
    return "".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=88)
    ap.add_argument("--max-fps", type=float, default=None,
                    help="FPS cap (default: EngineConfig.max_fps)")
    args = ap.parse_args()

    if not sys.stdin.isatty():
        print("terminal_viewer needs an interactive TTY")
        return

    from render_engine_tpu.demo.space_scene import build_space_engine
    from render_engine_tpu.logic.types import (
        InputState, KEY_W, KEY_A, KEY_S, KEY_D, KEY_SPACE, KEY_SHIFT)
    from render_engine_tpu.render.frame import to_srgb_u8

    print("building engine (first compile is slow)...")
    eng = build_space_engine(width=args.width, height=args.height,
                             capacity=256, num_asteroids=40, max_tris=16384)

    # the reference's sleep-based frame cap (gl_window.rs:434-453) driven
    # by the config (UserUploadInformation.max_fps, main.rs:46)
    from render_engine_tpu.runtime.host_loop import FpsLimiter

    max_fps = args.max_fps if args.max_fps is not None else eng.config.max_fps
    limiter = FpsLimiter(max_fps)

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    sys.stdout.write("\x1b[2J")
    frame = 0
    try:
        while True:
            keys, look = set(), [0.0, 0.0]
            while select.select([sys.stdin], [], [], 0)[0]:
                c = sys.stdin.read(1)
                if c == "q":
                    return
                m = {"w": KEY_W, "a": KEY_A, "s": KEY_S, "d": KEY_D,
                     " ": KEY_SPACE, "c": KEY_SHIFT}
                if c in m:
                    keys.add(m[c])
                elif c == "\x1b":  # arrow escape sequences
                    seq = sys.stdin.read(2)
                    if seq == "[A":
                        look[1] += 0.05
                    elif seq == "[B":
                        look[1] -= 0.05
                    elif seq == "[C":
                        look[0] += 0.05
                    elif seq == "[D":
                        look[0] -= 0.05
            import jax.numpy as jnp

            inp = InputState.idle(frame).with_keys(*keys)
            import dataclasses

            inp = dataclasses.replace(
                inp, mouse_delta=jnp.asarray(look, jnp.float32))
            t0 = time.time()
            img = eng.frame(inp, dt=limiter.delta_time() or 1 / 30)
            rgb = np.asarray(to_srgb_u8(img))
            sys.stdout.write(paint(rgb))
            sys.stdout.write(
                f"\x1b[0m{1.0 / max(time.time() - t0, 1e-6):5.1f} fps  "
                f"cap {max_fps:.0f}  frame {frame}  (q quits)\n")
            sys.stdout.flush()
            limiter.wait()
            frame += 1
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[0m\n")


if __name__ == "__main__":
    main()
