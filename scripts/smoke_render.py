"""Quick end-to-end render smoke: cube + sphere + light -> PNG.

Run: python scripts/smoke_render.py   (JAX_PLATFORMS=cpu for the CPU)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from render_engine_tpu.ecs import registry as R
from render_engine_tpu.ecs import world as W
from render_engine_tpu.logic import kinematics as K
from render_engine_tpu.math.camera import CameraBuilder
from render_engine_tpu.models import primitives
from render_engine_tpu.models.bank import ModelBankBuilder
from render_engine_tpu.render.frame import RenderSettings, render_frame, to_srgb_u8
from render_engine_tpu.render import skybox as SB


def main():
    bb = ModelBankBuilder()
    red = bb.add_material(albedo=(0.8, 0.2, 0.2))
    blue = bb.add_material(albedo=(0.2, 0.3, 0.9))
    glow = bb.add_material(albedo=(1.0, 0.9, 0.6), emissive=4.0)
    glass = bb.add_material(albedo=(0.3, 0.9, 0.6), alpha=0.4)
    cube_id = bb.add_model("cube", primitives.cube(1.0), material=red)
    sph_id = bb.add_model("sphere", primitives.uv_sphere(0.5, 12, 18), material=blue)
    star_id = bb.add_model("star", primitives.uv_sphere(0.5, 8, 12), material=glow)
    pane_id = bb.add_model("pane", primitives.quad(2.0), material=glass)
    bank = bb.finalize()

    cfg = W.WorldConfig(capacity=64, world_length=256.0, section_length=16.0)
    w = W.create_world(cfg)
    w, _ = W.spawn_host(
        w, 5,
        position=np.array(
            [[0.0, 0.0, -5.0], [1.6, 0.5, -4.0], [-2.0, 1.0, -6.0],
             [0.5, 0.2, -3.0], [0.0, 3.0, -5.0]],
            np.float32),
        model_id=np.array([cube_id, sph_id, star_id, pane_id, star_id], np.int32),
        scale=np.array([[1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 1], [0.3, 0.3, 0.3]],
                       np.float32),
        sortable=np.array([0, 0, 0, 0, R.SORTABLE_POINT], np.int32),
        light_diffuse=np.array(
            [[0, 0, 0]] * 4 + [[1.0, 0.95, 0.8]], np.float32),
        light_specular=np.array([[0, 0, 0]] * 4 + [[1.0, 1.0, 1.0]], np.float32),
        light_ambient=np.array([[0, 0, 0]] * 4 + [[0.05, 0.05, 0.05]], np.float32),
        light_atten=np.array([[0, 0]] * 4 + [[0.05, 0.01]], np.float32),
    )
    # shift positions into the world cube (centered-ish)
    w = w.replace(position=w["position"] + jnp.array([128.0, 128.0, 128.0]))
    w = K.refresh_transforms(w, bank.aabb_min, bank.aabb_max,
                             jnp.asarray(w.alive))

    cam = (
        CameraBuilder()
        .with_position(128.0, 129.0, 131.0)
        .with_yaw_pitch_degrees(-90.0, -10.0)
        .with_fov_degrees(60.0)
        .with_aspect(320.0 / 240.0)
        .with_near_far(0.1, 200.0)
        .with_draw_distance(200.0)
        .build()
    )

    settings = RenderSettings(width=320, height=240, max_tris=4096)
    cubemap = SB.starfield_cubemap(64)

    t0 = time.time()
    img = jax.jit(
        lambda w_, c_: render_frame(w_, c_, bank, settings, cubemap=cubemap)
    )(w, cam)
    img.block_until_ready()
    print(f"first frame (compile+run): {time.time()-t0:.1f}s")
    t0 = time.time()
    img = jax.jit(
        lambda w_, c_: render_frame(w_, c_, bank, settings, cubemap=cubemap)
    )(w, cam)
    img.block_until_ready()
    print(f"second frame: {time.time()-t0:.3f}s")

    arr = np.asarray(to_srgb_u8(img))
    print("image stats: mean", arr.mean(), "max", arr.max(),
          "nonzero px", (arr.sum(-1) > 0).mean())
    out = os.path.join(os.path.dirname(__file__), "..", "debug_out")
    os.makedirs(out, exist_ok=True)
    # minimal PNG writer to avoid PIL dependency
    import zlib, struct

    def write_png(path, rgb):
        h_, w_ = rgb.shape[:2]
        raw = b"".join(
            b"\x00" + rgb[i].tobytes() for i in range(h_)
        )
        def chunk(tag, data):
            c = struct.pack(">I", len(data)) + tag + data
            return c + struct.pack(">I", zlib.crc32(tag + data))
        png = (b"\x89PNG\r\n\x1a\n"
               + chunk(b"IHDR", struct.pack(">IIBBBBB", w_, h_, 8, 2, 0, 0, 0))
               + chunk(b"IDAT", zlib.compress(raw))
               + chunk(b"IEND", b""))
        with open(path, "wb") as f:
            f.write(png)

    write_png(os.path.join(out, "smoke.png"), arr)
    print("wrote debug_out/smoke.png")


if __name__ == "__main__":
    main()
