"""Find the first diverging frame/component between live and replay.

Runs on the CPU (a small engine; the golden jnp render path)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from render_engine_tpu.demo.space_scene import build_space_engine
from render_engine_tpu.logic.types import InputState, KEY_W
from render_engine_tpu.utils.hashing import world_hash


def snap(world):
    return {k: np.asarray(v) for k, v in world.comps.items()} | {
        "alive": np.asarray(world.alive), "comp_mask": np.asarray(world.comp_mask)
    }


def main():
    kw = dict(width=128, height=32, capacity=128, num_asteroids=40,
              max_tris=2048)
    eng = build_space_engine(**kw)
    frames = [(InputState.idle(i).with_keys(KEY_W), 1 / 30) for i in range(4)]

    live = []
    for inputs, dt in frames:
        eng.frame(inputs, dt, render=False)
        live.append(snap(eng.world))

    # replay WITHIN a fresh engine from the history baseline
    from render_engine_tpu.runtime.replay import Player

    eng2 = build_space_engine(**kw)
    player = Player(eng2, eng.history)
    print("baseline equal:",
          all(np.array_equal(snap(eng2.world)[k],
                             eng.history.baseline_world["comps"].get(
                                 k, snap(eng2.world)[k]))
              for k in eng2.world.comps))
    rep = []
    for i in range(4):
        player.step(render=False)
        rep.append(snap(eng2.world))

    for f in range(4):
        bad = [k for k in live[f] if not np.array_equal(live[f][k], rep[f][k])]
        if bad:
            print(f"frame {f} diverges in: {bad}")
            for k in bad[:3]:
                a, b = live[f][k], rep[f][k]
                idx = np.argwhere(a != b)
                print(f"  {k}: {len(idx)} cells differ; first:",
                      idx[:3].tolist())
                for j in idx[:3]:
                    print(f"    live={a[tuple(j)]!r} replay={b[tuple(j)]!r}")
            return
    print("NO DIVERGENCE over 4 frames")


if __name__ == "__main__":
    main()
