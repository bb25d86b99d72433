"""Shadow-LoV quality A/B: render the staged penumbra close-up at
shadow_lov_bias 2 (default) vs 3 and save both stills + a difference
summary into debug_out/ (the same reviewable-tradeoff contract as
scripts/pcf_quality_ab.py, VERDICT r4 #9).

shadow_lov_bias coarsens ONLY the shadow pass's geometry (the reference's
shadow_render_system_lov, render_thread.rs:97-104): the camera still sees
full-detail models; silhouettes in the 1024^2 depth map drop LoV bands.
The candidate win is the shadow batch-build + binning cost at a smaller
shadow_max_tris budget (bias 3 roughly halves the light-frustum request).

Runs anywhere (CPU forces interpret-mode kernels; identical math).
Usage: python scripts/shadow_lov_ab.py
"""

import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax.numpy as jnp

    from render_engine_tpu.demo.space_scene import build_space_engine
    from render_engine_tpu.ecs import world as W
    from render_engine_tpu.logic import kinematics as K
    from render_engine_tpu.logic.types import InputState
    from render_engine_tpu.math.camera import CameraBuilder
    from render_engine_tpu.render.frame import to_srgb_u8
    from render_engine_tpu.utils.png import encode_png

    os.makedirs("debug_out", exist_ok=True)
    imgs = {}
    maps = {}
    for bias in (2, 3):
        eng = build_space_engine(width=640, height=360, capacity=512,
                                 num_asteroids=120, max_tris=16384,
                                 shadow_lov_bias=bias,
                                 shadow_tile_budget=1.0,
                                 shadow_update_interval=1)
        eng.config.record_history = False
        # staging: LoV bands select by distance from the LIVE (ship)
        # camera at (1000, 1000, 1150) with draw_distance 1500, NOT the
        # detached still camera — so the occluder must sit within
        # 0.10 * 1500 = 150 units of the SHIP for bias 2 vs 3 to pick
        # different meshes (band 2 icosahedron vs band 3 tetrahedron).
        # Star A's spot at (1000, 1000, 880) beams along ~(0,-.287,.958)
        # TOWARD the spawn region: occluder at t=200 (97 units from the
        # ship, band 0), fat receiver at t=230; detached camera parks off
        # +x looking at the receiver so the silhouette crosses real pixels
        axis = np.array([0.0, -0.287, 0.958])
        axis /= np.linalg.norm(axis)
        light = np.array([1000.0, 1000.0, 880.0])
        op = light + 200.0 * axis   # occluder center
        sp = light + 230.0 * axis   # receiver center
        cp = sp + np.array([26.0, 11.8, -17.6])
        d = sp - cp
        yaw = math.degrees(math.atan2(d[2], d[0]))
        pitch = math.degrees(math.atan2(d[1], math.hypot(d[0], d[2])))
        cam = (CameraBuilder()
               .with_position(*cp)
               .with_yaw_pitch_degrees(yaw, pitch)
               .with_fov_degrees(60.0).with_aspect(640 / 360)
               .with_near_far(0.1, 400.0)
               .with_draw_distance(400.0).build())
        rock = eng.bank.model_index("asteroid")
        eng.world, _ = W.spawn_host(
            eng.world, 2,
            position=np.stack([op, sp]).astype(np.float32),
            model_id=np.array([rock, rock], np.int32),
            scale=np.array([[1.5, 1.5, 1.5], [6.0, 6.0, 6.0]], np.float32))
        eng.world = K.refresh_transforms(
            eng.world, eng.bank.aabb_min, eng.bank.aabb_max,
            jnp.asarray(eng.world.alive))
        # rendered frames so the round-robin maps the lights (shadow maps
        # only update inside the RENDER programs), then the detached view
        for i in range(6):
            eng.frame(InputState.idle(i), 1 / 60, render=True)
        img = eng.render_only(cam)
        arr = np.asarray(to_srgb_u8(img))
        imgs[bias] = arr
        path = f"debug_out/shadow_lov_{bias}.png"
        with open(path, "wb") as f:
            f.write(encode_png(arr))
        print(f"wrote {path}", flush=True)
        # the DIRECT artifact: star A's depth map. The scene still can hide
        # the change (the dense asteroid belt shadows the same rays at
        # every band — the staged occluder's texels lose the depth test to
        # nearer coarsest-band rocks either way), but the map shows every
        # silhouette at the biased LoV
        sh = eng.shadow_state
        depth = np.asarray(sh.maps[0])
        viz = np.clip((1.0 - depth) * 4.0, 0.0, 1.0)  # near = bright
        u8 = (np.stack([viz] * 3, -1) * 255).astype(np.uint8)
        maps[bias] = depth
        mpath = f"debug_out/shadow_lov_map_{bias}.png"
        with open(mpath, "wb") as f:
            f.write(encode_png(u8))
        print(f"wrote {mpath}", flush=True)

    diff = np.abs(imgs[2].astype(np.int16) - imgs[3].astype(np.int16))
    frac = float((diff.max(axis=-1) > 4).mean())
    mdiff = float((np.abs(maps[2] - maps[3]) > 1e-3).mean())
    print(f"scene pixels differing by >4/255: {frac:.3%} "
          f"(max {int(diff.max())}/255); star-A depth-map texels "
          f"differing by >1e-3: {mdiff:.3%} — the coarser-silhouette "
          "cost lives in the maps; see shadow_lov_map_{2,3}.png")


if __name__ == "__main__":
    main()
