"""Engine configuration — the UserUploadInformation analogue.

Mirrors the reference's all-in-one config struct (src/exports/load_models.rs:
17-71: window res, max_fps, world_section_length, camera, render systems,
models, instances, per-type logic maps, is_debugging flag, callbacks).
Everything flows through this one object into Engine; there are no globals
(the reference's lazy_static WORLD_SECTION_LENGTH / CAMERA / DELTA_TIME
dissolve into explicit state).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

from render_engine_tpu.ecs.registry import ComponentRegistry
from render_engine_tpu.logic.types import EntityType
from render_engine_tpu.render.frame import RenderSettings


@dataclasses.dataclass
class EngineConfig:
    # world (reference: world cube 16384, section length 64)
    capacity: int = 4096
    world_length: float = 16384.0
    section_length: float = 64.0
    world_min: tuple = (0.0, 0.0, 0.0)
    registry: ComponentRegistry = dataclasses.field(
        default_factory=ComponentRegistry
    )

    # frame
    render: RenderSettings = dataclasses.field(default_factory=RenderSettings)
    max_fps: float = 60.0  # host-loop cap (reference main.rs:46)
    # user render systems (load_models.rs UserLoadRenderSystems): a tuple of
    # render_system.RenderSystem, or a callable (bank) -> tuple built after
    # models are registered. None = one implicit default system over all
    # models.
    render_systems: Optional[object] = None

    # simulation
    entity_types: Sequence[EntityType] = ()
    logic_radius: Optional[float] = None  # None -> camera draw distance
    spawn_budget: int = 0
    collision_budget: int = 8
    # simultaneous contacts delivered per entity per frame (per-pair
    # callback parity with logic_flow.rs:537-655; overflow counted in
    # drop stats as collision_pair_dropped)
    collision_pairs: int = 4
    # entities with AABBs larger than a grid cell handled exactly via the
    # global candidate list (coarser-tree-level parity,
    # bounding_box_tree_v2.rs:21-109); overflow -> collision_large_dropped.
    # 32: "large" is orientation-dependent (the 8-corner AABB of a big
    # rotating model breathes across the halfspan threshold), so the live
    # count spikes — the demo's 10k-asteroid field peaked >8 and dropped
    # 17 pairs over a 50-frame bench at the old budget of 8. Cost is
    # L extra candidate columns + an (L, CAP) bool brute table of
    # elementwise compares.
    collision_large_budget: int = 32

    # scene setup: build_scene(engine) -> None, spawns initial entities and
    # registers models (the register_model_instances callback path,
    # pipeline.rs:186-208)
    build_scene: Optional[Callable] = None

    # level-of-view band end thresholds as fractions of the camera draw
    # distance. None = the reference's default bands (10/25/45/70/100%,
    # default_render_system.rs:240-255); scenes whose models are tiny can
    # pull bands in (custom_level_of_view analogue, model_storage.rs:294).
    lov_fractions: Optional[Sequence[float]] = None

    # shadows (reference budget: 6 maps @1024^2, <=1 new per frame)
    enable_shadows: bool = False
    shadow_resolution: int = 1024
    shadow_max_tris: int = 16384
    # shadow map slots (the reference's SHADOW budget, render_flow.rs:
    # 220-235). Each slot costs a per-frame PCF factor pass gated on
    # "slot mapped" — an UNMAPPED slot still materializes its conditional
    # outputs, so scenes that know their shadow-light count should size
    # this to it (demo: 2 spot lights -> 2). Overflow = round-robin
    # eviction, exactly the reference's staleness semantics.
    shadow_slots: int = 6
    # PCF factor subsampling (1 = full res; k cuts the dominant
    # latency-bound tap gather to 1/k^2 of the rows at a
    # penumbra-sharpness cost only — the factor upsamples in k x k
    # blocks). Default 3 (quality A/B stills in
    # debug_out/pcf_scale_{2,3}.png)
    shadow_pcf_scale: int = 3
    # user control over what casts shadows: bool[CAP] mask or trace-time
    # callable fn(world) -> bool[CAP] (the reference's user shadow draw
    # fns, load_models.rs shadow draw registration). None = every
    # model-bearing entity casts.
    shadow_caster_mask: object = None
    # render a new shadow map every N-th frame (1 = reference cadence of
    # <=1 map per frame; 2 halves per-frame shadow cost by stretching the
    # round-robin staleness — see shadows.render_shadow_map)
    shadow_update_interval: int = 1
    # LoV band shift for shadow casters (the shadow pass's own coarser
    # level-of-view — shadow_render_system_lov, render_thread.rs:97-104)
    shadow_lov_bias: int = 0

    # record/playback (the is_debugging switch, main.rs:53 / lib.rs:76)
    is_debugging: bool = False
    history_dir: str = "debug_logs"
    record_history: bool = True
