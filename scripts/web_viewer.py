"""Fly the demo scene from a browser — the GLFW-window analogue.

Serves frames over HTTP and folds browser keyboard/mouse state into each
frame's InputState (runtime/web_viewer.py). Run on the GPU host, then open
the printed URL (port-forward if remote):

    python scripts/web_viewer.py [--width 640 --height 360] [--port 8000]

WASD + Space/Shift fly, click the image for pointer-lock mouse look.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address; the viewer has no auth, so only "
                         "bind 0.0.0.0 on a trusted network (prefer "
                         "port-forwarding to the default loopback)")
    ap.add_argument("--asteroids", type=int, default=200)
    ap.add_argument("--max-fps", type=float, default=None)
    args = ap.parse_args()

    from render_engine_tpu.demo.space_scene import build_space_engine
    from render_engine_tpu.logic.types import InputState, NUM_KEYS
    from render_engine_tpu.render.frame import to_srgb_u8
    from render_engine_tpu.runtime.host_loop import FpsLimiter
    from render_engine_tpu.runtime.web_viewer import WebViewer

    print("building engine (first compile is slow)...", flush=True)
    eng = build_space_engine(
        width=args.width, height=args.height,
        capacity=1 << (args.asteroids + 64).bit_length(),
        num_asteroids=args.asteroids, max_tris=16384,
    )
    eng.config.record_history = False

    viewer = WebViewer(host=args.host, port=args.port)
    print(f"serving on {viewer.url}", flush=True)
    limiter = FpsLimiter(args.max_fps or eng.config.max_fps)
    frame = 0
    try:
        while True:
            dt = limiter.wait()
            keys, mouse = viewer.poll_input()
            inp = InputState(keys=keys, mouse_delta=mouse,
                             rng_seed=np.uint32(frame),
                             prev_keys=np.zeros(NUM_KEYS, bool))
            img = eng.frame(inp, dt=min(dt, 0.1))
            viewer.publish(np.asarray(to_srgb_u8(img)))
            frame += 1
            if frame % 120 == 0:
                stats = eng.fps_stats()
                print(f"frame {frame}: {stats.get('fps', 0):.1f} fps",
                      flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        viewer.close()


if __name__ == "__main__":
    main()
