"""Chip smoke test: the demo space scene's frame on an NVIDIA GPU, with every
kernel on its path compiled for the card.

Run from the repository root:

    python chip_smoke.py              # one GPU
    python chip_smoke.py --four-gpus  # four GPUs: the sharded phase only

One GPU runs three phases, each a function that raises on failure:

  1. device: JAX's platform and device kind, the card's name and power
     limit (``nvidia-smi``);
  2. parity at the headline size: the tile raster against
     ``raster_jnp.rasterize_depth_winner`` on the frame's batch and on a
     1024x1024 shadow batch, the gather resolve against
     ``raster_jnp.resolve_gbuffer``, and the tiled frame (fused shade kernel)
     against the XLA-shaded tiled frame and the jnp golden frame. Each
     kernel is timed beside the plain version XLA compiles;
  3. the headline main path through ``build_space_engine`` and
     ``Engine.frame``: warm frames, 20 timed frames, drop counters, a PNG,
     and record -> ``Player.replay_all`` world-hash equality.

``--four-gpus`` runs only the sharded phase: ``render_frame_sharded`` over a
4-GPU mesh against the single-GPU frame, and the 10k-entity sharded step
against the single step.

The script refuses to run without a GPU. Its last line of standard output is
one JSON object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

# the demo's headline frame (bench.py builds the same engine)
HEADLINE = dict(width=1920, height=1080, num_asteroids=10000, max_tris=16384)
TIMED_FRAMES = 20
WARM_FRAMES = 3
REPLAY_FRAMES = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def capacity_for(num_asteroids: int) -> int:
    """Entity capacity with headroom above the population (power of two)."""
    return 1 << (num_asteroids + 64).bit_length()


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------
def card_line() -> str:
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def device_phase(devs) -> dict:
    from render_engine_tpu import platform

    info = platform.device_record(devs)
    log(f"[device] {info}")
    log(f"[device] card: {card_line()}")
    return info


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def build_engine(width, height, num_asteroids, max_tris):
    from render_engine_tpu.demo.space_scene import build_space_engine

    eng = build_space_engine(width=width, height=height,
                             capacity=capacity_for(num_asteroids),
                             num_asteroids=num_asteroids, max_tris=max_tris)
    eng.config.record_history = False
    return eng


def run_frames(eng, n, start=0):
    from render_engine_tpu.logic.types import InputState

    img = None
    for i in range(n):
        img = eng.frame(InputState.idle(start + i), dt=1 / 60, render=True)
    return img


def time_ms(fn, *args, reps=5) -> float:
    """Mean device-fenced milliseconds per call (after one warm call)."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def frame_batch(eng):
    """The frame's screen-space triangle batch, as ``render_frame`` builds
    it."""
    import jax

    from render_engine_tpu.render.geometry import (
        build_triangle_batch,
        to_screen,
    )

    s, bank, systems = eng.config.render, eng.bank, eng.compiled_systems
    fn = jax.jit(lambda w, c: to_screen(build_triangle_batch(
        w, bank, c, max_tris=s.max_tris, systems=systems), s.width, s.height))
    return fn(eng.world, eng.camera)


def shadow_batch(eng):
    """The next shadow update's depth-only batch in map pixels, as
    ``shadows.render_shadow_map`` builds it."""
    import jax

    from render_engine_tpu.render import shadows as SHD
    from render_engine_tpu.render.geometry import (
        build_triangle_batch,
        to_screen,
    )

    cfg, bank = eng.config, eng.bank
    res = cfg.shadow_resolution

    def build(world, camera, shadow):
        _, _, light, face, _ = SHD.choose_light(shadow, world,
                                                camera.position)
        pv = SHD.light_proj_view(world, light, face=face)
        mask = cfg.shadow_caster_mask
        if callable(mask):
            mask = mask(world)
        b = build_triangle_batch(
            world, bank, camera, max_tris=cfg.shadow_max_tris,
            apply_lov=True, proj_view=pv, depth_only=True,
            lov_bias=cfg.shadow_lov_bias, instance_mask=mask)
        return to_screen(b, res, res)

    return jax.jit(build)(eng.world, eng.camera, eng.shadow_state), res


# ---------------------------------------------------------------------------
# phase 2: kernel parity against the plain references
# ---------------------------------------------------------------------------
def check_raster(batch, height, width, cfg, label, timing=True) -> dict:
    """Tile raster kernel vs ``raster_jnp.rasterize_depth_winner``: depth
    within 1e-6 where the winners agree, and at most 0.01% of pixels with
    another winner (exact edge ties: the two compilers may contract
    multiply-adds differently)."""
    import jax

    from render_engine_tpu.render import raster_jnp as RJ
    from render_engine_tpu.render import raster_pallas as RP

    kern = jax.jit(lambda b: RP.rasterize_depth_winner_pallas(
        b, height, width, cfg))
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda b: RJ.rasterize_depth_winner(
            b, height, width, cfg))
        d_r, w_r = (np.asarray(a) for a in ref(batch))
    d_k, w_k = (np.asarray(a) for a in kern(batch))
    same = w_k == w_r
    out = {
        "pixels": int(w_k.size),
        "covered": int((w_r >= 0).sum()),
        "winner_mismatch_frac": float(1.0 - same.mean()),
        "depth_max_abs_same_winner": float(
            np.abs(d_k - d_r)[same].max(initial=0.0)),
        "depth_max_abs_all": float(np.abs(d_k - d_r).max()),
    }
    if timing:
        with jax.default_matmul_precision("highest"):
            out["xla_ms"] = time_ms(ref, batch)
        out["kernel_ms"] = time_ms(kern, batch)
    log(f"[parity] raster {label} {height}x{width}: {out}")
    assert out["covered"] > 0, f"raster {label}: nothing covered"
    assert np.isfinite(d_k).all(), f"raster {label}: non-finite depth"
    assert out["winner_mismatch_frac"] <= 1e-4, out
    assert out["depth_max_abs_same_winner"] <= 1e-6, out
    return out


def check_resolve(batch, bank, camera, height, width, cfg) -> dict:
    """Winner-row gather resolve (``raster_pallas.render_gbuffers_pallas``)
    vs ``raster_jnp.resolve_gbuffer`` on the same winners: normal and
    albedo within 1e-5, material and ids equal. World position is
    reconstructed from depth on the tiled path (interpolated on the jnp
    path), so it is held to 1e-3 of its magnitude: one float32 step of NDC
    depth near the 1500-unit far plane is ~0.1 world units, and the
    unprojection's w cancels for far pixels, so no float32 unprojection of
    the same depth would meet 1e-5 either."""
    import jax

    from render_engine_tpu.render import raster_jnp as RJ
    from render_engine_tpu.render import raster_pallas as RP

    gb, _, _, _ = jax.jit(lambda b, pv: RP.render_gbuffers_pallas(
        b, bank, height, width, cfg, proj_view=pv))(batch, camera.proj_view())
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda b, d, w: RJ.resolve_gbuffer(b, bank, d, w))(
            batch, gb.depth, gb.tri_id)
    cov = np.asarray(gb.tri_id) >= 0
    pos_k, pos_r = np.asarray(gb.position)[cov], np.asarray(ref.position)[cov]
    out = {
        "covered": int(cov.sum()),
        "normal_max_abs": float(np.abs(np.asarray(gb.normal)
                                       - np.asarray(ref.normal)).max()),
        "albedo_max_abs": float(np.abs(np.asarray(gb.albedo)
                                       - np.asarray(ref.albedo)).max()),
        "material_equal": bool((np.asarray(gb.material)
                                == np.asarray(ref.material)).all()),
        "position_max_rel": float(
            (np.abs(pos_k - pos_r).max(axis=-1)
             / np.maximum(np.abs(pos_r).max(axis=-1), 1.0)).max(initial=0.0)),
    }
    log(f"[parity] resolve {height}x{width}: {out}")
    assert out["covered"] > 0
    assert out["normal_max_abs"] <= 1e-5, out
    assert out["albedo_max_abs"] <= 1e-5, out
    assert out["material_equal"], out
    assert out["position_max_rel"] <= 1e-3, out
    return out


def frame_diff(a, b) -> dict:
    diff = np.abs(a - b).max(axis=-1)
    return {"within_1e-2": float((diff < 1e-2).mean()),
            "max": float(diff.max()), "median": float(np.median(diff))}


def render_fn(eng, settings):
    """``render_frame`` of ``eng``'s scene under ``settings``, jitted, as a
    function of (world, camera, shadow_state)."""
    import jax

    from render_engine_tpu.render.frame import render_frame

    bank, cube, atlas, systems = (eng.bank, eng.cubemap, eng.atlas,
                                  eng.compiled_systems)
    return jax.jit(lambda w, c, sh: render_frame(
        w, c, bank, settings, cubemap=cube, atlas=atlas, shadow_state=sh,
        systems=systems))


def check_frame(eng, timing=True) -> dict:
    """The tiled frame with the fused shade kernel vs the tiled frame shaded
    by XLA (same raster: the shade kernel alone) and vs the jnp golden
    frame, with every tile budget at 1.0: at least 99.5% of pixels within
    1e-2, max < 0.05, median 0. Shadows run at PCF scale 1: with a coarser
    scale each path subsamples on its own pixel grid (per 8-row tile vs per
    image), which moves penumbra pixels by design.

    With ``timing``, the fused and XLA-shaded renders are also timed at the
    engine's own settings (its tile budgets and PCF scale): the shade
    kernel against XLA as the frame runs it."""
    import jax

    s = dataclasses.replace(eng.config.render, shadow_tile_budget=1.0,
                            texture_tile_budget=1.0)
    variants = {
        "fused": dataclasses.replace(s, backend="tiled", fused_shading=True),
        "tiled_xla": dataclasses.replace(s, backend="tiled",
                                         fused_shading=False),
        "jnp": dataclasses.replace(s, backend="jnp", fused_shading=False),
    }
    imgs, times = {}, {}
    args = (eng.world, eng.camera,
            dataclasses.replace(eng.shadow_state, pcf_scale=1))
    for name, st in variants.items():
        with jax.default_matmul_precision(
                "highest" if name == "jnp" else "default"):
            fn = render_fn(eng, st)
            imgs[name] = np.asarray(fn(*args))
            if timing:
                times[name] = time_ms(fn, *args)
    out = {"vs_tiled_xla": frame_diff(imgs["fused"], imgs["tiled_xla"]),
           "vs_jnp": frame_diff(imgs["fused"], imgs["jnp"])}
    if timing:
        out["frame_ms_pcf1_budgets1"] = times
        own = (eng.world, eng.camera, eng.shadow_state)
        out["frame_ms_engine_settings"] = {
            name: time_ms(render_fn(eng, dataclasses.replace(
                eng.config.render, backend="tiled", fused_shading=fused)),
                *own)
            for name, fused in (("fused", True), ("tiled_xla", False))}
    log(f"[parity] frame {s.width}x{s.height}: {out}")
    for name in imgs:
        assert np.isfinite(imgs[name]).all(), f"{name} frame not finite"
    for key in ("vs_tiled_xla", "vs_jnp"):
        assert out[key]["within_1e-2"] >= 0.995, (key, out[key])
        assert out[key]["max"] < 0.05, (key, out[key])
        assert out[key]["median"] == 0.0, (key, out[key])
    return out


def parity_phase(eng, timing=True) -> dict:
    from render_engine_tpu.render import shadows as SHD

    s = eng.config.render
    batch = frame_batch(eng)
    sbatch, res = shadow_batch(eng)
    return {
        "raster_frame": check_raster(batch, s.height, s.width, s.raster,
                                     "frame", timing),
        "raster_shadow": check_raster(
            sbatch, res, res, SHD.shadow_raster_cfg(
                eng.config.shadow_max_tris), "shadow", timing),
        "resolve": check_resolve(batch, eng.bank, eng.camera, s.height,
                                 s.width, s.raster),
        "frame": check_frame(eng, timing),
    }


# ---------------------------------------------------------------------------
# phase 3: the headline main path
# ---------------------------------------------------------------------------
def main_path_phase(eng, out_dir, timed=TIMED_FRAMES, replay=REPLAY_FRAMES,
                    card="") -> dict:
    """Warm frames, ``timed`` device-fenced frames, drop counters, a PNG,
    and record -> replay world-hash equality on the same engine."""
    import jax

    from render_engine_tpu.logic.types import InputState
    from render_engine_tpu.render.frame import to_srgb_u8
    from render_engine_tpu.runtime.replay import Player
    from render_engine_tpu.utils.hashing import world_hash
    from render_engine_tpu.utils.png import write_png

    s = eng.config.render
    t0 = time.perf_counter()
    img = run_frames(eng, WARM_FRAMES, start=1000)
    jax.block_until_ready((img, eng.world))
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    img = run_frames(eng, timed, start=2000)
    jax.block_until_ready((img, eng.world))
    ms = (time.perf_counter() - t0) / timed * 1e3
    log(f"[main] {s.width}x{s.height}: {ms:.3f} ms/frame over {timed} "
        f"frames ({card}; warm-up incl. compile {warm_s:.1f} s)")
    img = np.asarray(img)
    assert img.shape == (s.height, s.width, 3), img.shape
    assert np.isfinite(img).all(), "frame not finite"
    assert img.max() > 0.0, "frame is black"

    drops = eng.drop_stats()
    log(f"[main] drop_stats: {drops}")

    os.makedirs(out_dir, exist_ok=True)
    png = os.path.join(out_dir, "chip_smoke_frame.png")
    write_png(png, np.asarray(to_srgb_u8(img)))
    log(f"[main] wrote {png}")

    # record -> replay on the same engine (its compiled programs are reused)
    eng.config.record_history = True
    eng.reset()
    for i in range(replay):
        eng.frame(InputState.idle(i), dt=1 / 60, render=True)
    live = world_hash(eng.world)
    hist = eng.history
    eng.config.record_history = False
    eng.reset()
    replayed = Player(eng, hist).replay_all(render=False)[-1]
    log(f"[main] replay {replay} frames: live {live[:16]} "
        f"replay {replayed[:16]}")
    assert live == replayed, "replay diverged from the live run"
    return {"ms_per_frame": ms, "drops": drops, "replay_equal": True}


# ---------------------------------------------------------------------------
# phase 4: four GPUs
# ---------------------------------------------------------------------------
def four_gpu_phase(eng, n=4) -> dict:
    """``render_frame_sharded`` over an n-device mesh vs the single-device
    tiled frame (max < 0.03, fewer than 0.5% of pixels differing by more
    than 1e-6: exact shared-edge ties may land on either triangle), and the
    sharded step vs the single step (positions within 1e-5, entity axis
    partitioned). Shadow and texture tile budgets are fractions of the
    tiles each program shades — a rank's own band when sharded — so both
    frames run at 1.0 and every tile is shaded on both sides."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from render_engine_tpu.logic.step import make_step
    from render_engine_tpu.logic.types import InputState
    from render_engine_tpu.parallel.mesh import make_mesh, world_sharding
    from render_engine_tpu.parallel.render import render_frame_sharded
    from render_engine_tpu.render.frame import render_frame

    mesh = make_mesh(n)
    bank, cube, atlas, systems = (eng.bank, eng.cubemap, eng.atlas,
                                  eng.compiled_systems)
    settings = dataclasses.replace(eng.config.render, backend="tiled",
                                   shadow_tile_budget=1.0,
                                   texture_tile_budget=1.0)
    shadow = eng.shadow_state
    cfg = eng.config
    step = make_step(tuple(cfg.entity_types), logic_radius=cfg.logic_radius,
                     spawn_budget=cfg.spawn_budget,
                     collision_budget=cfg.collision_budget)
    dt = jnp.float32(1.0 / 60.0)
    inputs = InputState.idle(0)

    def single(world, camera, inputs, dt):
        world, camera = step(world, camera, inputs, dt, bank.aabb_min,
                             bank.aabb_max)
        img = render_frame(world, camera, bank, settings, cubemap=cube,
                           atlas=atlas, shadow_state=shadow, systems=systems)
        return world, img

    def sharded(world, camera, inputs, dt):
        world, camera = step(world, camera, inputs, dt, bank.aabb_min,
                             bank.aabb_max)
        img = render_frame_sharded(world, camera, bank, settings, mesh,
                                   cubemap=cube, atlas=atlas,
                                   shadow_state=shadow, systems=systems)
        return world, img

    single_fn = jax.jit(single)
    w1, ref = single_fn(eng.world, eng.camera, inputs, dt)
    ref = np.asarray(ref)
    wsh = world_sharding(eng.world, mesh)
    rep = NamedSharding(mesh, P())
    fn = jax.jit(sharded, in_shardings=(wsh, rep, rep, rep))
    with mesh:
        w4, img = fn(jax.device_put(eng.world, wsh),
                     jax.device_put(eng.camera, rep),
                     jax.device_put(inputs, rep), dt)
        img = np.asarray(img)
        t_mesh = time_ms(fn, jax.device_put(eng.world, wsh),
                         jax.device_put(eng.camera, rep),
                         jax.device_put(inputs, rep), dt)
    t_single = time_ms(single_fn, eng.world, eng.camera, inputs, dt)
    assert img.shape == ref.shape, (img.shape, ref.shape)
    diff = np.abs(img - ref).max(axis=-1)
    pos4 = w4.comps["position"]
    shard_rows = pos4.addressable_shards[0].data.shape[0]
    out = {
        "image_max": float(diff.max()),
        "image_frac_gt_1e-6": float((diff > 1e-6).mean()),
        "pos_max_abs": float(np.abs(np.asarray(pos4)
                                    - np.asarray(w1.comps["position"])).max()),
        "shard_rows": int(shard_rows),
        "entities": int(np.asarray(w4.alive).sum()),
        "single_ms": t_single,
        "mesh_ms": t_mesh,
    }
    log(f"[four-gpus] {settings.width}x{settings.height} over {n} devices: "
        f"{out}")
    assert np.isfinite(img).all()
    assert out["image_max"] < 0.03, out
    assert out["image_frac_gt_1e-6"] < 0.005, out
    assert out["pos_max_abs"] < 1e-5, out
    assert shard_rows == cfg.capacity // n, (
        f"entity axis not partitioned: {shard_rows} rows per device")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded phase on four GPUs")
    ap.add_argument("--out", default="debug_out",
                    help="directory for the frame PNG")
    args = ap.parse_args(argv)

    from render_engine_tpu import platform

    n_dev = 4 if args.four_gpus else 1
    devs = platform.gpu_devices(n_dev)
    platform.enable_compile_cache()
    info = device_phase(devs)
    card = card_line()

    t0 = time.perf_counter()
    eng = build_engine(**HEADLINE)
    log(f"[main] engine {HEADLINE} built in {time.perf_counter() - t0:.1f} s")
    if args.four_gpus:
        run_frames(eng, WARM_FRAMES)  # shadow maps in place
        four_gpu_phase(eng, n_dev)
        info["count"] = n_dev
    else:
        run_frames(eng, WARM_FRAMES)  # compiles the frame; maps in place
        parity_phase(eng)
        main_path_phase(eng, args.out, card=card)
        info["count"] = len(devs)
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
