"""PCF scale quality A/B: render the demo's shadowed station view at
pcf_scale 2 (current default) vs 3 and save both stills + a difference
summary into debug_out/ (VERDICT r4 #9: the tradeoff must be reviewable).

pcf_scale subsamples the latency-bound PCF row gather (the shading-side
shadow cost floor) and nearest-upsamples the factor back: 2 -> 1/4 the
rows, 3 -> 1/9. The cost is penumbra blockiness (k x k factor blocks).

Runs on the GPU, or on the CPU with JAX_PLATFORMS=cpu (interpret-mode
kernels; identical math).
Usage: python scripts/pcf_quality_ab.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from render_engine_tpu.demo.space_scene import build_space_engine
    from render_engine_tpu.logic.types import InputState
    from render_engine_tpu.render.frame import to_srgb_u8
    from render_engine_tpu.utils.png import encode_png

    from render_engine_tpu.math.camera import CameraBuilder

    os.makedirs("debug_out", exist_ok=True)
    imgs = {}
    for k in (2, 3):
        eng = build_space_engine(width=640, height=360, capacity=512,
                                 num_asteroids=120, max_tris=16384,
                                 shadow_pcf_scale=k,
                                 # exact PCF coverage: this close-up fills
                                 # the spot frustum, so the bench's 0.28
                                 # tile compaction would degrade most
                                 # tiles to lit and hide the comparison
                                 shadow_tile_budget=1.0,
                                 shadow_update_interval=1)
        eng.config.record_history = False
        # CLOSE-UP of the shadowed station (the wide spawn view showed
        # <0.01% differing pixels — penumbra edges need a filled frame):
        # station sits at ~(960, 985, 920); park just off its lit corner
        # looking back at it so shadow boundaries cross the image
        import math

        # stage the shadow ALONG star A's spot axis (position
        # (1000, 1000, 880), direction ~(0, -0.287, 0.958) normalized,
        # fov 1.2 rad): occluder at t=25, big receiver at t=55, camera
        # off to +x looking at the receiver — guarantees a penumbra
        # boundary fills real pixels
        sp = np.array([1000.0, 984.2, 932.6])   # receiver center
        cp = np.array([1026.0, 996.0, 915.0])
        d = sp - cp
        yaw = math.degrees(math.atan2(d[2], d[0]))
        pitch = math.degrees(math.atan2(d[1], math.hypot(d[0], d[2])))
        cam = (CameraBuilder()
               .with_position(*cp)
               .with_yaw_pitch_degrees(yaw, pitch)
               .with_fov_degrees(60.0).with_aspect(640 / 360)
               .with_near_far(0.1, 400.0)
               .with_draw_distance(400.0).build())
        # spawn a deliberate occluder between star A (1000, 1000, 880) and
        # the station so a soft shadow edge crosses the station face the
        # camera sees (the stock scene has no guaranteed caster alignment)
        import jax.numpy as jnp

        from render_engine_tpu.ecs import world as W
        from render_engine_tpu.logic import kinematics as K

        rock = eng.bank.model_index("asteroid")
        eng.world, _ = W.spawn_host(
            eng.world, 2,
            # occluder on-axis at t=25; fat receiver on-axis at t=55
            position=np.array([[1000.0, 992.8, 903.9],
                               [1000.0, 984.2, 932.6]], np.float32),
            model_id=np.array([rock, rock], np.int32),
            scale=np.array([[1.5, 1.5, 1.5], [6.0, 6.0, 6.0]], np.float32))
        eng.world = K.refresh_transforms(
            eng.world, eng.bank.aabb_min, eng.bank.aabb_max,
            jnp.asarray(eng.world.alive))
        # a few RENDERED frames so the shadow round-robin maps the
        # lights (the shadow update lives in the render program — headless
        # frames never touch the maps); then a detached-camera render
        # (frame() snaps the live camera to the ship, so the close-up
        # goes through render_only)
        for i in range(6):
            eng.frame(InputState.idle(i), 1 / 60, render=True)
        img = eng.render_only(cam)
        arr = np.asarray(to_srgb_u8(img))
        imgs[k] = arr
        path = f"debug_out/pcf_scale_{k}.png"
        with open(path, "wb") as f:
            f.write(encode_png(arr))
        print(f"wrote {path}", flush=True)

    diff = np.abs(imgs[2].astype(np.int16) - imgs[3].astype(np.int16))
    frac = float((diff.max(axis=-1) > 4).mean())
    print(f"pixels differing by >4/255: {frac:.3%} "
          f"(max {int(diff.max())}/255) — the blockier penumbra edge is "
          "the whole visual cost; see the two PNGs side by side")


if __name__ == "__main__":
    main()
