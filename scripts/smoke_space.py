"""Space-scene smoke: build the demo engine, run frames, dump a PNG,
record + replay and compare hashes.

Run: python scripts/smoke_space.py   (JAX_PLATFORMS=cpu for the CPU)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from render_engine_tpu import platform
from render_engine_tpu.demo.space_scene import build_space_engine
from render_engine_tpu.logic.types import InputState, KEY_W
from render_engine_tpu.render.frame import to_srgb_u8
from render_engine_tpu.runtime.replay import Player
from render_engine_tpu.utils.hashing import world_hash
from render_engine_tpu.utils.png import write_png


def main():
    platform.enable_compile_cache()
    print(f"backend: {platform.backend()}")
    t0 = time.time()
    eng = build_space_engine(width=320, height=240, capacity=128,
                             num_asteroids=40, max_tris=8192)
    print(f"engine built in {time.time()-t0:.1f}s, "
          f"{int(np.asarray(eng.world.alive).sum())} entities")

    t0 = time.time()
    img = eng.frame(InputState.idle(0).with_keys(KEY_W), dt=1 / 30)
    img.block_until_ready()
    print(f"first frame (compile): {time.time()-t0:.1f}s")

    t0 = time.time()
    n = 5
    for i in range(1, n + 1):
        img = eng.frame(InputState.idle(i).with_keys(KEY_W), dt=1 / 30)
    img.block_until_ready()
    print(f"{n} frames: {(time.time()-t0)/n*1e3:.0f} ms/frame")
    print("stats:", eng.fps_stats())

    out = os.path.join(os.path.dirname(__file__), "..", "debug_out")
    os.makedirs(out, exist_ok=True)
    write_png(os.path.join(out, "space.png"), np.asarray(to_srgb_u8(img)))
    print("wrote debug_out/space.png")
    h_live = world_hash(eng.world)

    # record/replay roundtrip
    path = eng.flush_history()
    print("history flushed:", path, f"({eng.history.num_frames} frames)")
    from render_engine_tpu.runtime.history import HistoryLog
    from render_engine_tpu.demo.space_scene import space_config
    from render_engine_tpu.runtime.engine import Engine

    hist = HistoryLog.load(eng.config.history_dir)
    eng2 = build_space_engine(width=320, height=240, capacity=128,
                              num_asteroids=40, max_tris=8192)
    player = Player(eng2, hist)
    hashes = player.replay_all(render=False)
    h_replay = hashes[-1]
    print("live  hash:", h_live[:16])
    print("replay hash:", h_replay[:16])
    assert h_live == h_replay, "REPLAY DIVERGED"
    print("DETERMINISTIC REPLAY OK")


if __name__ == "__main__":
    main()
