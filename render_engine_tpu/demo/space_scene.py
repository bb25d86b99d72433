"""The space scene: stars, orbiting asteroids, a wormhole, a mine producer,
and a player ship.

Port of the reference demo game (src/main.rs:20-62, src/space_logic/):

  * camera starts at (1000, 1000, 1150) in a 16,384-unit world with section
    length 64 (main.rs:22, 48-51)
  * 2 stars as spot-light emitters with rotation velocity, drawn emissive at
    6x skybox brightness (solar_system/sun.rs:94-159,
    render_systems/render_system_setup.rs:57-77)
  * 40 asteroids with random orbit parameters around the suns, carried by a
    custom per-instance component (the AngleRelativeSun pattern,
    solar_system/asteroid.rs:19-171)
  * a wormhole as an alpha-blended model; colliding with it gives the ship
    a velocity impulse (wormhole.rs:64-75, user.rs:17-50)
  * a mine producer that spawns drifting mines during play (AddEntity
    through the replayable change stream, mine_producer.rs:67-80)
  * inertial WASD ship/camera input with mouse-look (user_input.rs:21-111)
  * a 6-face space skybox (skybox.rs:4-19) — procedural starfield here
    (assets are not copied)
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from render_engine_tpu.ecs import changes as C
from render_engine_tpu.ecs import registry as R
from render_engine_tpu.logic.types import (
    EntityType,
    KEY_A,
    KEY_D,
    KEY_S,
    KEY_SHIFT,
    KEY_SPACE,
    KEY_W,
)
from render_engine_tpu.math.camera import CameraBuilder
from render_engine_tpu.models import primitives
from render_engine_tpu.render import skybox as SB
from render_engine_tpu.render.frame import RenderSettings
from render_engine_tpu.runtime.config import EngineConfig
from render_engine_tpu.runtime.engine import Engine

TYPE_STAR = 0
TYPE_ASTEROID = 1
TYPE_WORMHOLE = 2
TYPE_MINE_PRODUCER = 3
TYPE_MINE = 4
TYPE_USER = 5
TYPE_STATION = 6  # textured OBJ decoration (the OBJ+MTL loader path)

SHIP_ACCEL = 40.0
SHIP_DECAY = 0.96  # inertial decay (MovementFactor analogue)
WORMHOLE_IMPULSE = 120.0
MINE_SPAWN_PERIOD = 4.0  # seconds between mines


# ---------------------------------------------------------------------------
# custom components (registered before trace — asteroid.rs:87 pattern)
# ---------------------------------------------------------------------------
CUSTOM_COMPONENTS = (
    R.ComponentSpec("orbit_angle", (), "float32"),
    R.ComponentSpec("orbit_radius", (), "float32"),
    R.ComponentSpec("orbit_speed", (), "float32"),
    R.ComponentSpec("orbit_center", (3,), "float32"),
    R.ComponentSpec("spawn_timer", (), "float32"),
)


# ---------------------------------------------------------------------------
# logic callbacks (pure, vectorized)
# ---------------------------------------------------------------------------
def asteroid_orbit_logic(world, dt, mask, cs):
    """Advance orbit angle; position = center + r*(cos a, 0, sin a)
    (asteroid.rs orbit parameterization)."""
    a = world["orbit_angle"] + world["orbit_speed"] * dt
    r = world["orbit_radius"]
    center = world["orbit_center"]
    pos = center + jnp.stack(
        [r * jnp.cos(a), jnp.zeros_like(a), r * jnp.sin(a)], axis=-1
    )
    cs = C.with_update(cs, "orbit_angle", a, mask)
    cs = C.with_update(cs, "position", pos, mask)
    return cs


def mine_producer_logic(world, dt, mask, rng, cs):
    """Every MINE_SPAWN_PERIOD seconds, spawn one mine at a random offset.

    Demonstrates AddEntity inside the jitted step: the spawn lands in the
    fixed-budget queue and is replayable because rng comes from the recorded
    frame seed."""
    timer = world["spawn_timer"] + jnp.where(mask, dt, 0.0)
    fire = mask & (timer >= MINE_SPAWN_PERIOD)
    timer = jnp.where(fire, 0.0, timer)
    cs = C.with_update(cs, "spawn_timer", timer, mask)

    # one producer fires at a time is fine: pick the first firing producer
    any_fire = jnp.any(fire)
    src = jnp.argmax(fire)
    offset = jax.random.uniform(rng, (3,), minval=-8.0, maxval=8.0)
    vel = jax.random.uniform(rng, (3,), minval=-2.0, maxval=2.0)
    budget = cs.spawns.budget
    row = (jnp.arange(budget) == 0) & any_fire
    cs = C.queue_spawn(
        cs, world.config.registry, row,
        position=jnp.broadcast_to(world["position"][src] + offset, (budget, 3)),
        velocity=jnp.broadcast_to(vel, (budget, 3)),
        scale=jnp.full((budget, 3), 0.4, jnp.float32),
        type_id=jnp.full(budget, TYPE_MINE, jnp.int32),
        model_id=jnp.full(budget, _MINE_MODEL[0], jnp.int32),
        flags=jnp.full(budget, int(R.FLAG_COLLIDABLE), jnp.uint32),
    )
    return cs


_MINE_MODEL = [0]  # patched at scene build (model ids are bank-assigned)


def user_input_logic(world, camera, inputs, dt, cs):
    """Inertial WASD flight + mouse look (user_input.rs:21-111): thrust
    along the camera basis, velocity decays by SHIP_DECAY per frame."""
    camera = camera.rotated(inputs.mouse_delta[0], inputs.mouse_delta[1])
    k = inputs.keys.astype(jnp.float32)
    fwd = camera.direction()
    up = jnp.array([0.0, 1.0, 0.0], jnp.float32)
    right = jnp.cross(fwd, up)
    right = right / jnp.linalg.norm(right)
    accel = (
        fwd * (k[KEY_W] - k[KEY_S])
        + right * (k[KEY_D] - k[KEY_A])
        + up * (k[KEY_SPACE] - k[KEY_SHIFT])
    ) * SHIP_ACCEL

    user_mask = world.flag_set(R.FLAG_USER)
    vel = (world["velocity"] + accel[None] * dt) * SHIP_DECAY
    cs = C.with_update(cs, "velocity", vel, user_mask)
    return cs, camera


def user_collision_logic(world, other_idx, mask, cs, other_type=None):
    """Wormhole hit => forward velocity impulse (user.rs:17-50).

    ``other_type`` rides the engine's compacted contact rows — the
    ``world["type_id"][other_idx]`` fallback is a full-capacity 1-D int
    gather per pair slot)."""
    if other_type is None:
        other_type = world["type_id"][other_idx]
    hit_wormhole = mask & (other_type == TYPE_WORMHOLE)
    vel = world["velocity"]
    speed = jnp.linalg.norm(vel, axis=-1, keepdims=True)
    direction = jnp.where(speed > 1e-6, vel / jnp.maximum(speed, 1e-6),
                          jnp.array([0.0, 0.0, -1.0]))
    boosted = direction * WORMHOLE_IMPULSE
    return C.with_update(cs, "velocity", boosted, hit_wormhole)


ENTITY_TYPES = (
    EntityType("star", TYPE_STAR),  # spins via ang_vel kinematics
    EntityType("asteroid", TYPE_ASTEROID, logic=asteroid_orbit_logic),
    EntityType("wormhole", TYPE_WORMHOLE),
    EntityType("mine_producer", TYPE_MINE_PRODUCER,
               random_logic=mine_producer_logic),
    EntityType("mine", TYPE_MINE),
    EntityType("user", TYPE_USER, user_input=user_input_logic,
               collision=user_collision_logic),
    EntityType("station", TYPE_STATION),
)


def _write_station_asset(out_dir: str) -> str:
    """Write a small textured station model (OBJ + MTL + PPM) so the demo
    exercises the real asset-loading path (model_storage.rs:116-266 loads
    OBJ+MTL with textures; the reference's binary assets are not copied, so
    the demo generates deterministic equivalents)."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    obj_path = os.path.join(out_dir, "station.obj")
    bump_path = os.path.join(out_dir, "bumps.ppm")
    if os.path.exists(obj_path) and os.path.exists(bump_path):
        return obj_path

    # procedural panel texture (P6 PPM): grid lines + rivets
    s = 64
    yy, xx = np.mgrid[0:s, 0:s]
    base = np.full((s, s, 3), 120, np.uint8)
    base[(yy % 16 < 2) | (xx % 16 < 2)] = (60, 60, 70)
    base[(yy % 16 == 8) & (xx % 16 == 8)] = (200, 200, 210)
    with open(os.path.join(out_dir, "panels.ppm"), "wb") as fh:
        fh.write(b"P6\n%d %d\n255\n" % (s, s) + base.tobytes())

    # tangent-space normal map: domed rivets + recessed grid lines (the
    # fourth texture pair; map_Bump through the real MTL path)
    cy = (yy % 16).astype(np.float32) - 8.0
    cx = (xx % 16).astype(np.float32) - 8.0
    r2 = cx * cx + cy * cy
    dome = np.maximum(0.0, 9.0 - r2) / 9.0  # height in [0, 1], radius 3
    h = 0.6 * dome
    h -= 0.3 * (((yy % 16) < 2) | ((xx % 16) < 2)).astype(np.float32)
    gy, gx = np.gradient(h * 4.0)
    nvec = np.stack([-gx, -gy, np.ones_like(h)], axis=-1)
    nvec /= np.linalg.norm(nvec, axis=-1, keepdims=True)
    nmap = ((nvec + 1.0) * 0.5 * 255.0 + 0.5).astype(np.uint8)
    with open(bump_path, "wb") as fh:
        fh.write(b"P6\n%d %d\n255\n" % (s, s) + nmap.tobytes())

    with open(os.path.join(out_dir, "station.mtl"), "w") as fh:
        fh.write("newmtl hull\nKd 0.8 0.8 0.85\nKs 0.6 0.6 0.6\n"
                 "map_Kd panels.ppm\nmap_Bump bumps.ppm\n")

    # a 10-unit cube with per-face UVs and normals
    lines = ["mtllib station.mtl"]
    r = 5.0
    corners = [(x, y, z) for x in (-r, r) for y in (-r, r) for z in (-r, r)]
    for c in corners:
        lines.append("v %g %g %g" % c)
    for u, v in ((0, 0), (1, 0), (1, 1), (0, 1)):
        lines.append("vt %d %d" % (u, v))
    for n in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
              (0, 0, -1)):
        lines.append("vn %d %d %d" % n)
    # faces as corner indices (1-based) per axis-aligned quad
    quads = [  # (4 corner ids, normal id)
        ((5, 6, 8, 7), 1), ((1, 3, 4, 2), 2), ((3, 7, 8, 4), 3),
        ((1, 2, 6, 5), 4), ((2, 4, 8, 6), 5), ((1, 5, 7, 3), 6),
    ]
    lines.append("usemtl hull")
    for (a, b, c, d), n in quads:
        lines.append(f"f {a}/1/{n} {b}/2/{n} {c}/3/{n}")
        lines.append(f"f {a}/1/{n} {c}/3/{n} {d}/4/{n}")
    with open(obj_path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return obj_path


# ---------------------------------------------------------------------------
# scene construction
# ---------------------------------------------------------------------------
def build_scene(engine: Engine, num_asteroids: int = 40, seed: int = 42,
                normal_maps: bool = True):
    bb = engine.bank_builder
    # the star's 6x brightness comes from the light_sources render system's
    # emissive boost (render_system_setup.rs:57-77), not the material
    star_mat = bb.add_material(albedo=(1.0, 0.85, 0.5), emissive=1.0)
    rock_mat = bb.add_material(albedo=(0.45, 0.38, 0.33))
    worm_mat = bb.add_material(albedo=(0.4, 0.2, 0.9), alpha=0.45)
    mine_mat = bb.add_material(albedo=(0.7, 0.1, 0.1))
    prod_mat = bb.add_material(albedo=(0.2, 0.7, 0.4), alpha=0.7)

    star_model = bb.add_model("star", primitives.uv_sphere(14.0, 12, 18),
                              material=star_mat)
    rock_full = bb.add_model("asteroid", primitives.asteroid(2.0, 8, 12,
                                                             seed=seed),
                             material=rock_mat)
    rock_lod = bb.add_model("asteroid_lod", primitives.icosahedron(2.0),
                            material=rock_mat)
    rock_far = bb.add_model("asteroid_far", primitives.tetrahedron(2.0),
                            material=rock_mat)
    bb.set_levels_of_view(rock_full, [rock_full, rock_lod, rock_lod,
                                      rock_far, rock_far, rock_far])
    worm_model = bb.add_model("wormhole", primitives.uv_sphere(6.0, 8, 12),
                              material=worm_mat)
    mine_model = bb.add_model("mine", primitives.cube(1.0), material=mine_mat)
    prod_model = bb.add_model("mine_producer", primitives.cube(4.0),
                              material=prod_mat)
    _MINE_MODEL[0] = mine_model

    # textured OBJ station through the real loader + atlas path
    from render_engine_tpu.render.textures import TextureAtlasBuilder

    atlas_builder = TextureAtlasBuilder(layer_size=64)
    obj_path = _write_station_asset("debug_out/assets")
    station_model = bb.add_obj("station", obj_path,
                               atlas_builder=atlas_builder)
    if not normal_maps:
        # A/B knob for measurement: dropping the normal-map role keeps
        # the 48-wide packed rows (normal maps force 64, see raster_pallas
        # channel layout); BENCH_NORMAL_MAPS=0 flips it from bench.py
        for d in bb._mats:
            d["texture_normal"] = -1
    engine.set_atlas(atlas_builder.finalize())

    rng = np.random.default_rng(seed)
    base = np.array([1000.0, 1000.0, 1000.0], np.float32)

    # --- 2 stars: emissive, spinning, spot-light emitters (sun.rs) -------
    star_pos = np.stack([base + [0, 0, -120], base + [180, 30, -260]])
    engine.spawn(
        2,
        position=star_pos,
        model_id=np.full(2, star_model, np.int32),
        type_id=np.full(2, TYPE_STAR, np.int32),
        ang_vel=np.array([[0.0, 0.15, 0.0], [0.0, -0.1, 0.0]], np.float32),
        sortable=np.full(2, R.SORTABLE_SPOT, np.int32),
        light_diffuse=np.array([[1.0, 0.9, 0.7], [0.9, 0.8, 1.0]], np.float32),
        light_specular=np.full((2, 3), 0.8, np.float32),
        light_ambient=np.full((2, 3), 0.04, np.float32),
        light_atten=np.full((2, 2), [0.004, 0.00005], np.float32),
        light_direction=np.array([[0.0, -0.3, 1.0], [-0.5, 0.0, 1.0]],
                                 np.float32),
        light_cutoff=np.full((2, 2), [np.cos(0.6), np.cos(1.0)], np.float32),
        light_radius=np.full(2, 400.0, np.float32),
        light_fov=np.full(2, 1.2, np.float32),
        flags=np.full(2, int(R.FLAG_ALWAYS_LOGIC), np.uint32),
    )

    # --- asteroids orbiting the two stars (asteroid.rs) ------------------
    # Small scenes orbit the stars like the reference demo; large synthetic
    # fields (the 10k-asteroid benchmark config) orbit virtual centers
    # scattered through a wide shell so frustum + grid culling have real
    # work to do ("culling active", BASELINE config 2).
    n = num_asteroids
    if n <= 500:
        which_star = rng.integers(0, 2, n)
        centers = star_pos[which_star]
    else:
        dirs = rng.normal(size=(n, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        shell = rng.uniform(200.0, 1400.0, (n, 1)) ** 1.0
        centers = (base + dirs * shell).astype(np.float32)
        centers = np.clip(centers, 100.0, 16284.0)
    radii = rng.uniform(40.0, 160.0, n).astype(np.float32)
    angles = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    speeds = rng.uniform(0.05, 0.3, n).astype(np.float32) * np.where(
        rng.random(n) < 0.5, 1.0, -1.0
    ).astype(np.float32)
    pos = centers + np.stack(
        [radii * np.cos(angles), rng.uniform(-20, 20, n).astype(np.float32),
         radii * np.sin(angles)], axis=-1)
    centers_y = centers.copy()
    centers_y[:, 1] = pos[:, 1]  # orbit in the asteroid's own y-plane
    engine.spawn(
        n,
        position=pos.astype(np.float32),
        model_id=np.full(n, rock_full, np.int32),
        type_id=np.full(n, TYPE_ASTEROID, np.int32),
        scale=rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32).repeat(3, 1),
        ang_vel=rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
        orbit_angle=angles,
        orbit_radius=radii,
        orbit_speed=speeds,
        orbit_center=centers_y.astype(np.float32),
        flags=np.full(n, int(R.FLAG_COLLIDABLE), np.uint32),
    )

    # --- wormhole + mine producer (transparent models) -------------------
    engine.spawn(
        1,
        position=(base + np.array([60.0, 0.0, -60.0]))[None],
        model_id=np.array([worm_model], np.int32),
        type_id=np.array([TYPE_WORMHOLE], np.int32),
        flags=np.array([int(R.FLAG_COLLIDABLE) | int(R.FLAG_TRANSPARENT)],
                       np.uint32),
    )
    engine.spawn(
        1,
        position=(base + np.array([-80.0, 10.0, -100.0]))[None],
        model_id=np.array([prod_model], np.int32),
        type_id=np.array([TYPE_MINE_PRODUCER], np.int32),
        flags=np.array([int(R.FLAG_TRANSPARENT) | int(R.FLAG_ALWAYS_LOGIC)],
                       np.uint32),
        spawn_timer=np.zeros(1, np.float32),
    )

    # --- the textured station (OBJ+MTL+texture loader path) --------------
    engine.spawn(
        1,
        position=(base + np.array([-40.0, -15.0, -80.0]))[None],
        model_id=np.array([station_model], np.int32),
        type_id=np.array([TYPE_STATION], np.int32),
        ang_vel=np.array([[0.0, 0.05, 0.0]], np.float32),
    )

    # --- the player ship (user entity; camera-coupled) -------------------
    engine.spawn(
        1,
        position=np.array([[1000.0, 1000.0, 1150.0]], np.float32),
        velocity=np.zeros((1, 3), np.float32),
        type_id=np.array([TYPE_USER], np.int32),
        flags=np.array(
            [int(R.FLAG_USER) | int(R.FLAG_ALWAYS_LOGIC)
             | int(R.FLAG_COLLIDABLE) | int(R.FLAG_USER_ALWAYS_COLLIDES)],
            np.uint32),
    )

    # star-splat skybox: gather-free background (see render/skybox.py).
    # Real 6-face cubemap alternative (the reference's space skybox,
    # skybox.rs:4-19): engine.set_skybox(
    #     SB.cubemap_rows(SB.starfield_cubemap())) — one row gather per
    # pixel (~6 ms/frame at 1080p), exact vs the 4-tap golden sampler
    engine.set_skybox(SB.make_starfield(2400))

    # user render systems: the default lit deferred system over everything
    # plus the unlit 6x light-source system for the stars — the demo's
    # render-system setup (render_system_setup.rs:7-122) driven through the
    # Engine's single fused pass
    from render_engine_tpu.prelude.default_render_system import (
        default_render_systems,
    )

    engine.set_render_systems(
        lambda bank: default_render_systems(
            bank, emissive_models=(star_model,))
    )


def space_config(
    *,
    capacity: int = 256,
    num_asteroids: int = 40,
    width: int = 800,
    height: int = 600,
    max_tris: int = 32768,
    is_debugging: bool = False,
    spawn_budget: int = 4,
    enable_shadows: bool = True,
    shadow_resolution: int | None = None,
    shadow_max_tris: int | None = None,
    shadow_tile_budget: float = 0.28,
    normal_maps: bool = True,
    shadow_update_interval: int | None = None,
    shadow_pcf_scale: int | None = None,
    light_tile_budget: int | None = None,
    shadow_slots: int | None = None,
    raster_tile_budget: int | None = None,
    collision_large_budget: int | None = None,
    shadow_lov_bias: int | None = None,
    trans_tile_budget: int | None = None,
) -> EngineConfig:
    from render_engine_tpu.render.raster_jnp import RasterConfig

    # shadows are ALWAYS on (the reference never renders without its
    # ShadowFlow, render_flow.rs:247-335); quality scales with the target:
    # tiny offscreen targets (tests/CI) take a 128^2 map, real frames 1024^2
    if shadow_resolution is None:
        shadow_resolution = 1024 if height >= 240 else 128
    if shadow_max_tris is None:
        # at shadow_lov_bias 2 the light-frustum request is ~7k triangles
        # (shadow_triangle_dropped counts overflow; 8192 keeps it 0)
        shadow_max_tris = 8192 if height >= 240 else 1024
    # real frames stretch the round-robin: the reference's budget is AT
    # MOST one new map per frame (shadow_flow.rs:111-133) — staleness
    # grows with light count there (N lights = N-frame refresh), so a
    # skip interval is the same tradeoff on the time axis. At interval 3
    # each of the demo's 2 lights refreshes every 6 frames.
    # Tiny CI targets keep the per-frame cadence so scheduling tests see it.
    if shadow_update_interval is None:
        shadow_update_interval = 3 if height >= 240 else 1
    # the scene has exactly 2 shadow-casting lights (the 2 star spots, 1
    # map each): slots beyond that are never mapped but still cost their
    # per-frame PCF conditional's output materialization. CI keeps the
    # reference budget of 6 so eviction/scheduling tests see it.
    if shadow_slots is None:
        shadow_slots = 2 if height >= 240 else 6
    if raster_tile_budget is None:
        # 112: at 96 the 10k field leaves ~15 opaque candidates dropped
        # once exact (post-bf16-fix) culling delivers the full visible set
        # (debug_logs/diag_budgets.py); 112 zeroes it
        raster_tile_budget = 112

    registry = R.ComponentRegistry(custom=CUSTOM_COMPONENTS)
    if collision_large_budget is None:
        collision_large_budget = 32
    return EngineConfig(
        capacity=capacity,
        world_length=16384.0,
        section_length=64.0,
        registry=registry,
        collision_large_budget=collision_large_budget,
        render=RenderSettings(width=width, height=height, max_tris=max_tris,
                              max_point_lights=8, max_spot_lights=8,
                              light_tile_budget=(light_tile_budget or 0),
                              # space scenes are mostly sky: compact the
                              # latency-bound PCF/texture gathers to the
                              # most-occupied tiles (overflow degrades to
                              # lit/untextured, never crashes). The shadow
                              # budget is PER SLOT and applies after the
                              # per-slot light-frustum tile cull.
                              shadow_tile_budget=shadow_tile_budget,
                              # 0.04 covers the station's textured tiles
                              # with headroom at the demo viewpoint
                              # (texture_tile_overflow stays 0 in drops);
                              # tiny CI targets have so few tiles the
                              # fraction needs to be large
                              texture_tile_budget=(0.04 if height >= 240
                                                   else 0.5),
                              # pair_budget: live (tile, tri) pairs run
                              # ~1.5 per visible triangle; 3x max_tris
                              # cuts the binning scatter's row count 2.7x
                              # (overflow would show in drop stats)
                              # tile_budget 64 measured SLOWER than 96
                              # (52.6 vs 54.2 FPS) with 5x the candidate
                              # drops — per-candidate costs don't dominate
                              # trans_tile_budget 64: the wormhole/producer
                              # spheres stack ~200 transparent candidates
                              # into a handful of tiles at the spawn view —
                              # the default 16 dropped exactly those
                              raster=RasterConfig(tile_budget=raster_tile_budget,
                                                  trans_tile_budget=(
                                                      trans_tile_budget
                                                      or 64),
                                                  global_budget=32,
                                                  pair_budget=3 * max_tris)),
        entity_types=ENTITY_TYPES,
        # pulled-in LoV bands (reference default ends them at 10/25/45/70/
        # 100% of draw distance): the demo's 2-unit rocks subtend < 7 px
        # beyond 22% of the 1500 draw distance at 1080p, so the coarse
        # bands are visually identical while carrying 5x fewer triangles —
        # the custom_level_of_view tuning the reference exposes per model
        # (model_storage.rs:294-298)
        lov_fractions=(0.10, 0.15, 0.20, 0.25, 0.30),
        spawn_budget=spawn_budget,
        build_scene=lambda e: build_scene(e, num_asteroids=num_asteroids,
                                          normal_maps=normal_maps),
        is_debugging=is_debugging,
        enable_shadows=enable_shadows,
        shadow_resolution=shadow_resolution,
        shadow_max_tris=shadow_max_tris,
        shadow_slots=shadow_slots,
        shadow_update_interval=shadow_update_interval,
        **({} if shadow_pcf_scale is None
           else {"shadow_pcf_scale": shadow_pcf_scale}),
        # shadow casters use two-bands-coarser LoV (the reference's
        # shadow_render_system_lov, render_thread.rs:97-104): the light
        # frustum sees ~2.4x the camera-visible triangle count at full
        # detail (shadow_triangle_dropped counted ~14k over an 6144 budget
        # without it); at bias 2 the requested count fits the budget
        # (sweepable via BENCH_SHADOW_LOV for coarser-silhouette A/Bs)
        shadow_lov_bias=2 if shadow_lov_bias is None else shadow_lov_bias,
    )


def build_space_engine(**kw) -> Engine:
    cfg = space_config(**kw)
    camera = (
        CameraBuilder()
        .with_position(1000.0, 1000.0, 1150.0)
        .with_yaw_pitch_degrees(-90.0, 0.0)
        .with_fov_degrees(60.0)
        .with_aspect(cfg.render.width / cfg.render.height)
        # far plane == draw distance: the reference has ONE render distance
        # (far_draw_distance doubles as the render distance,
        # camera_object.rs:211-214), so nothing renders beyond the last LoV
        # band — a far plane past draw_distance would draw a coarsest-band
        # shell the reference would have culled
        .with_near_far(0.5, 1500.0)
        .with_draw_distance(1500.0)
        .build()
    )
    return Engine(cfg, camera=camera)
