"""Render systems: user-defined pipelines bound to sets of models.

The reference's render system is a generated GLSL program + GL resources +
three user draw callbacks, assembled by a typestate builder chain
(src/render_system/builder.rs:61-241) from a shader-declaration DSL
(system_information.rs) with std140 uniform-block management and texture
arrays. README pillar 1: "user-defined render systems bound to sets of
models".

Array-native redesign (SURVEY.md section 7 mapping): string codegen dissolves
into Python composition — a ``RenderSystem`` is a *configuration record*
binding a set of bank models to raster + lighting behaviour:

  * vertex/fragment DSL + codegen       ->  the fixed G-buffer contract
    (geometry.py attributes); per-system knobs cover what the demo's
    shaders varied (emissive boost, lighting on/off, transparency pass)
  * uniform blocks + DrawParam writes   ->  the ``uniforms`` dict consumed
    at shade time (type-checked at build like rendering.rs:147-182)
  * per-system G-buffer FBO             ->  all systems raster into ONE
    shared G-buffer via depth-merge (BASELINE config 3's "G-buffer reuse
    across render systems"), then one fused lighting pass
  * draw callbacks (opaque/light/transparent) -> entity routing masks via
    model sets + sortable buckets + transparency flags

``render_frame_systems`` renders any number of systems; one system is
exactly the render_frame fast path.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from render_engine_tpu.ecs.world import World
from render_engine_tpu.models.bank import ModelBank
from render_engine_tpu.render import lighting as L
from render_engine_tpu.render import skybox as SB
from render_engine_tpu.render.gbuffer import GBuffer
from render_engine_tpu.render.frame import RenderSettings, pick_rasterizer
from render_engine_tpu.render.geometry import build_triangle_batch, to_screen
from render_engine_tpu.render.raster_jnp import resolve_gbuffer


@dataclasses.dataclass(frozen=True)
class RenderSystem:
    """One user-defined pipeline over a subset of models."""

    name: str
    model_ids: tuple  # bank model indices this system draws
    lit: bool = True  # False = unlit/emissive-style output
    emissive_boost: float = 1.0  # the stars' 6x-brightness knob
    casts_lov: bool = True  # apply level-of-view swapping
    uniforms: tuple = ()  # ((name, value), ...) build-time constants
    # per-frame user draw callback (the reference's render-system draw
    # functions receiving a DrawParam, exports/rendering.rs:57-396 +
    # system_information.rs draw fn registration): fn(DrawParam) -> None,
    # called at TRACE time inside the render program each frame. When set,
    # ONLY entities this callback draws (DrawParam.draw_models) render for
    # this system, and its uniform writes override the build-time values
    # with traced per-frame data. None = static routing (all bound models).
    draw: object = None
    # user fragment shading fn(ShadeParam) -> (..., 3) rgb — the analogue
    # of the reference's user-written GLSL fragment bodies
    # (system_information.rs:486-559 shader declarations): replaces the
    # default deferred Blinn-Phong for this system's pixels. Traced Python
    # over the G-buffer contract instead of GLSL strings. None = default
    # shading. Runs on EVERY path: the XLA shading paths, the fused Pallas
    # kernel (as a post-kernel resolve hook), and the sharded frame.
    shade: object = None


class RenderSystemBuilder:
    """Mirror of the reference's typestate chain (builder.rs:61-241):
    constants -> models -> lighting -> transparency -> build. Python keeps
    the *order-enforced completeness* contract via required() checks at
    build time instead of type states."""

    def __init__(self, name: str):
        self._name = name
        self._models: list[int] = []
        self._lit = True
        self._emissive_boost = 1.0
        self._lov = True
        self._uniforms: list[tuple] = []
        self._draw = None
        self._shade = None

    def with_models(self, *model_ids: int) -> "RenderSystemBuilder":
        self._models.extend(int(m) for m in model_ids)
        return self

    def with_lighting(self, lit: bool = True) -> "RenderSystemBuilder":
        self._lit = lit
        return self

    def with_emissive_boost(self, boost: float) -> "RenderSystemBuilder":
        self._emissive_boost = float(boost)
        return self

    def with_levels_of_view(self, enabled: bool) -> "RenderSystemBuilder":
        self._lov = enabled
        return self

    def write_uniform(self, name: str, value) -> "RenderSystemBuilder":
        """Type-checked named constant (the DrawParam::write_uniform_value
        contract, rendering.rs:147-182)."""
        if not isinstance(name, str) or not name:
            raise TypeError("uniform name must be a non-empty string")
        if not isinstance(value, (int, float, tuple)):
            raise TypeError(
                f"uniform {name!r}: unsupported type {type(value).__name__}"
            )
        self._uniforms.append((name, value))
        return self

    def with_fragment_shading(self, fn) -> "RenderSystemBuilder":
        """Custom fragment shading ``fn(ShadeParam) -> rgb`` — the user
        shader-body half of the reference's shader DSL
        (system_information.rs:486-559), as traced Python over the G-buffer
        contract. The fn sees per-pixel position/normal/albedo/depth/
        material, the camera, the frame's light table, this system's
        uniform values (including per-frame DrawParam writes), and the
        default-shaded color to build on. Shades BOTH layers — the opaque
        deferred result and the system's transparent forward pass (the
        reference runs its user transparency draw through the same
        generated program, render_system.rs:501). Runs on every path — the
        XLA shading paths, the fused Pallas kernel (post-kernel hook over
        the G-buffer contract), and the sharded frame."""
        if not callable(fn):
            raise TypeError("fragment shading function must be callable")
        self._shade = fn
        return self

    def with_draw_function(self, fn) -> "RenderSystemBuilder":
        """Per-frame draw callback ``fn(DrawParam) -> None`` — the
        reference's with_draw_function registration (builder.rs draw-fn
        states feeding render_system.rs:410-595). The callback runs at
        trace time inside the render program every frame: it decides which
        of the system's models/instances draw (``DrawParam.draw_models``,
        possibly gated on traced conditions), writes per-frame uniform
        values, and may toggle the skybox."""
        if not callable(fn):
            raise TypeError("draw function must be callable")
        self._draw = fn
        return self

    def build(self) -> RenderSystem:
        if not self._models:
            raise ValueError(
                f"render system {self._name!r}: no models bound "
                "(the builder chain requires full specification)"
            )
        return RenderSystem(
            name=self._name,
            model_ids=tuple(self._models),
            lit=self._lit,
            emissive_boost=self._emissive_boost,
            casts_lov=self._lov,
            uniforms=tuple(self._uniforms),
            draw=self._draw,
            shade=self._shade,
        )


# uniforms with shading semantics (the DrawParam::write_uniform_value
# contract, rendering.rs:147-182 — here the closed set the fixed deferred
# shader actually reads; unknown names fail at compile time, the analogue
# of GLSL rejecting an undeclared uniform)
RECOGNIZED_UNIFORMS = {
    "albedo_tint": tuple,  # (r, g, b) multiplies material albedo
    "alpha_scale": float,  # multiplies material alpha (routes transparent)
    "emissive_boost": float,  # multiplies the system's emissive boost
}


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["model_system", "sys_table", "sys_lov"],
    meta_fields=["names", "src"],
)
@dataclasses.dataclass(frozen=True)
class CompiledSystems:
    """Render systems compiled to per-model routing + per-system shading
    attribute tables — the array-native RenderSystem::draw: instead of one
    raster pass per system (render_system.rs:410-595), systems become DATA
    on the one fused raster/resolve/shade pass. G-buffer "reuse across
    systems" is then inherent: there is exactly one G-buffer.

    model_system: (num_models,) int32 — which system draws each bank model
        (-1 = no system: the model is not drawn, matching the reference
        where only models bound to a render system exist on screen).
        Level-of-view variant models inherit their base model's system.
    sys_table: (S, 6) f32 rows [unlit, boost, tint r, tint g, tint b,
        alpha_scale] consumed at shade time via the packed attribute table.
    sys_lov: (S,) f32 1/0 — casts_lov per system.
    """

    model_system: jnp.ndarray
    sys_table: jnp.ndarray
    sys_lov: jnp.ndarray
    names: tuple
    # the source RenderSystem records (static; carries the per-frame draw
    # callbacks). () for systems compiled before callbacks existed.
    src: tuple = ()

    def has_draw_callbacks(self) -> bool:
        return any(s.draw is not None for s in self.src)

    def has_shade_callbacks(self) -> bool:
        return any(s.shade is not None for s in self.src)


def compile_systems(systems, bank: ModelBank) -> CompiledSystems:
    import numpy as np

    systems = tuple(systems)
    nm = bank.num_models
    model_system = np.full(nm, -1, np.int32)
    table = np.zeros((max(len(systems), 1), 6), np.float32)
    lov = np.ones(max(len(systems), 1), np.float32)
    lov_table = np.asarray(bank.lov_table)
    for s, sys_ in enumerate(systems):
        boost = float(sys_.emissive_boost)
        tint = (1.0, 1.0, 1.0)
        alpha_scale = 1.0
        for name, value in sys_.uniforms:
            if name not in RECOGNIZED_UNIFORMS:
                if sys_.shade is not None:
                    continue  # consumed by the system's ShadeParam.uniforms
                raise ValueError(
                    f"render system {sys_.name!r}: unknown uniform {name!r} "
                    f"(recognized: {sorted(RECOGNIZED_UNIFORMS)}; arbitrary "
                    "names need a with_fragment_shading consumer)"
                )
            if name == "albedo_tint":
                tint = tuple(float(v) for v in value)
            elif name == "alpha_scale":
                alpha_scale = float(value)
            elif name == "emissive_boost":
                boost *= float(value)
        table[s] = [0.0 if sys_.lit else 1.0, boost, *tint, alpha_scale]
        lov[s] = 1.0 if sys_.casts_lov else 0.0
        for m in sys_.model_ids:
            if not (0 <= m < nm):
                raise ValueError(
                    f"render system {sys_.name!r}: model id {m} not in bank")
            if model_system[m] >= 0 and model_system[m] != s:
                raise ValueError(
                    f"model {m} bound to two render systems "
                    f"({systems[model_system[m]].name!r} and {sys_.name!r})")
            model_system[m] = s
            # LoV variants draw with their base model's system
            for variant in lov_table[m]:
                if model_system[variant] < 0:
                    model_system[variant] = s
    return CompiledSystems(
        model_system=jnp.asarray(model_system),
        sys_table=jnp.asarray(table),
        sys_lov=jnp.asarray(lov),
        names=tuple(s.name for s in systems),
        src=systems,
    )


def entity_shade_attrs(world: World, systems: CompiledSystems,
                       sys_table: jnp.ndarray | None = None) -> jnp.ndarray:
    """(CAP, 6) per-entity [unlit, boost, tint rgb, alpha_scale] rows from
    each entity's model's system (identity row for unrouted models).
    ``sys_table`` overrides the compiled static table with per-frame traced
    rows (DrawParam uniform writes)."""
    table = systems.sys_table if sys_table is None else sys_table
    mid = world["model_id"]
    ms = systems.model_system[jnp.clip(mid, 0, systems.model_system.shape[0] - 1)]
    s = jnp.clip(ms, 0, table.shape[0] - 1)
    rows = table[s]
    identity = jnp.asarray([0.0, 1.0, 1.0, 1.0, 1.0, 1.0], jnp.float32)
    return jnp.where(((ms >= 0) & (mid >= 0))[:, None], rows, identity)


class DrawParam:
    """Per-frame draw-callback context — the array-native DrawParam
    (exports/rendering.rs:57-396). The reference hands user draw functions
    a handle that issues instanced GL draws filtered by sortable bucket,
    writes uniforms, toggles the skybox, and exposes the ECS / camera /
    input history read-only. Here draws become INSTANCE MASKS and uniform
    writes become traced per-frame shading rows, both folded into the one
    fused pass — the callback runs at trace time, so conditions must be
    traced values (``when=...``), not Python ``if`` on world data."""

    def __init__(self, system: RenderSystem, world: World, camera, inputs,
                 bank: ModelBank):
        self.world = world
        self.camera = camera
        self.input = inputs  # InputState, or None on input-less paths
        self._system = system
        self._bound = frozenset(int(m) for m in system.model_ids)
        self._bank = bank
        self._mask = jnp.zeros(world.capacity, bool)
        self._uniform_writes: list[tuple] = []
        self.skybox: object = None  # None = leave as configured

    # -- reads (get_logical_ecs / get_camera / get_input_history) ---------
    def get_ecs(self) -> World:
        return self.world

    def get_camera(self):
        return self.camera

    def get_input_history(self):
        return self.input

    # -- draws (draw_model_with_sortable_index, rendering.rs:270-386) -----
    def draw_models(self, *model_ids, sortable=None, when=None):
        """Draw this frame's instances of ``model_ids`` (must be bound to
        this system). ``sortable``: optional int or iterable of sortable
        bucket values — only instances in those buckets draw (the
        reference's component_indexes filter). ``when``: optional traced
        (or static) bool scalar gating the whole call."""
        if not model_ids:
            raise ValueError(
                f"render system {self._system.name!r}: draw_models needs at "
                "least one model id")
        mid = self.world["model_id"]
        m = jnp.zeros(self.world.capacity, bool)
        for model in model_ids:
            model = int(model)
            if model not in self._bound:
                raise ValueError(
                    f"render system {self._system.name!r}: cannot draw "
                    f"model {model} — not bound to this system "
                    f"(bound: {sorted(self._bound)})")
            m = m | (mid == model)
        if sortable is not None:
            if isinstance(sortable, (int, float)):
                sortable = (int(sortable),)
            sm = jnp.zeros(self.world.capacity, bool)
            for bucket in sortable:
                sm = sm | (self.world["sortable"] == int(bucket))
            m = m & sm
        if when is not None:
            m = m & jnp.asarray(when, bool)
        self._mask = self._mask | m

    def draw_skybox(self, on=True):
        """Toggle the skybox for this frame (toggle_rendering_skybox,
        rendering.rs:57-64); ``on`` may be a traced bool."""
        self.skybox = on

    # -- uniforms (write_uniform_value, rendering.rs:67-182) --------------
    def write_uniform(self, name: str, value):
        """Write a per-frame uniform value (may be traced). Unknown names
        fail at trace time — the analogue of GLSL rejecting an undeclared
        uniform — unless this system has a fragment-shading fn, whose
        ShadeParam.uniforms consumes arbitrary names."""
        if name not in RECOGNIZED_UNIFORMS and self._system.shade is None:
            raise ValueError(
                f"render system {self._system.name!r}: unknown uniform "
                f"{name!r} (recognized: {sorted(RECOGNIZED_UNIFORMS)}; "
                "arbitrary names need a with_fragment_shading consumer)")
        self._uniform_writes.append((name, value))


@dataclasses.dataclass(frozen=True)
class DrawContext:
    """Per-frame dynamic state produced by the systems' draw callbacks.
    ``allowed``: bool[CAP] instance gate (None = static routing only);
    ``sys_table``: traced (S, 6) shading rows (None = compiled constants);
    ``skybox_on``: bool scalar (None = leave the configured background);
    ``uniform_writes``: per-system {name: value} of this frame's
    DrawParam.write_uniform calls, for ShadeParam.uniforms."""

    allowed: object = None
    sys_table: object = None
    skybox_on: object = None
    uniform_writes: tuple = ()


def run_draw_callbacks(systems: CompiledSystems, world: World, camera,
                       inputs, bank: ModelBank) -> DrawContext:
    """Invoke every system's draw callback for this frame (trace time) and
    fold the results into a DrawContext consumed by render_frame.

    Entities of systems WITHOUT a callback stay statically routed; entities
    of systems WITH one draw only if the callback drew them this frame
    (the reference only renders what the user's draw fn submits,
    render_system.rs:410-595)."""
    if not systems.has_draw_callbacks():
        return DrawContext()
    mid = world["model_id"]
    ent_sys = systems.model_system[
        jnp.clip(mid, 0, systems.model_system.shape[0] - 1)]
    allowed = jnp.ones(world.capacity, bool)
    sys_table = systems.sys_table
    skybox_on = None
    uniform_writes = [{} for _ in systems.src]
    for s, sys_ in enumerate(systems.src):
        if sys_.draw is None:
            continue
        dp = DrawParam(sys_, world, camera, inputs, bank)
        sys_.draw(dp)
        mine = ent_sys == s
        allowed = jnp.where(mine, dp._mask, allowed)
        if dp.skybox is not None:
            skybox_on = dp.skybox
        uniform_writes[s] = dict(dp._uniform_writes)
        if dp._uniform_writes:
            row = sys_table[s]
            unlit, boost = row[0], row[1]
            tint = row[2:5]
            alpha_scale = row[5]
            for name, value in dp._uniform_writes:
                if name == "albedo_tint":
                    tint = jnp.asarray(value, jnp.float32).reshape(3)
                elif name == "alpha_scale":
                    alpha_scale = jnp.asarray(value, jnp.float32)
                elif name == "emissive_boost":
                    # REPLACE the build-time uniform (GL uniform-write
                    # semantics, matching render_frame_systems) — row[1]
                    # already folds any build-time emissive_boost uniform,
                    # so multiplying it would double-apply.
                    boost = jnp.float32(sys_.emissive_boost) * jnp.asarray(
                        value, jnp.float32)
            new_row = jnp.concatenate([
                jnp.stack([unlit, boost]), tint,
                alpha_scale.reshape(1)])
            sys_table = sys_table.at[s].set(new_row)
    return DrawContext(allowed=allowed, sys_table=sys_table,
                       skybox_on=skybox_on,
                       uniform_writes=tuple(uniform_writes))


@dataclasses.dataclass(frozen=True)
class ShadeParam:
    """Per-pixel inputs handed to a system's fragment-shading fn — the
    G-buffer contract the reference's generated fragment shaders consume
    (first_pass_frag.glsl in/out blocks + the uniform blocks of
    system_information.rs:486-559), plus the default-shaded color so user
    shaders can post-process instead of recomputing lighting.

    All image-shaped fields share the same leading shape (the path's pixel
    layout: (H, W) or the tiled tall layout); the fn must be shape-
    polymorphic over it (elementwise jnp code is)."""

    position: jnp.ndarray  # (..., 3) world-space position
    normal: jnp.ndarray  # (..., 3) world-space normal
    albedo: jnp.ndarray  # (..., 3) material/texture albedo
    depth: jnp.ndarray  # (...,) NDC depth
    material: jnp.ndarray  # (...,) int32 material id
    covered: jnp.ndarray  # (...,) bool: a triangle won this pixel
    base_color: jnp.ndarray  # (..., 3) default deferred shading result
    camera: object  # the frame camera
    lights: object  # lighting.LightArrays (the frame's light upload)
    uniforms: dict  # this system's uniform values (static + per-frame)


def triangle_system_ids(batch, world: World,
                        systems: CompiledSystems) -> jnp.ndarray:
    """Per-triangle render-system index: triangle -> entity -> model ->
    system (the routing the raster used). (max_tris,) int32."""
    ent = jnp.clip(batch.entity, 0, world.capacity - 1)
    mid = world["model_id"][ent]
    return systems.model_system[
        jnp.clip(mid, 0, systems.model_system.shape[0] - 1)]


def shade_systems_color(color, gbuf, px_sys, covered, camera, lights,
                        systems: CompiledSystems,
                        uniform_writes=None) -> jnp.ndarray:
    """Run each shade-fn system's fragment shading over its own pixels
    (``px_sys``: per-pixel system index). Pixels of systems without a
    shade fn keep the default deferred result. Shared by the XLA paths
    (apply_custom_shading) and the fused-kernel post-hook
    (frame._fused_custom_shading)."""
    for s, sys_ in enumerate(systems.src):
        if sys_.shade is None:
            continue
        uniforms = {name: value for name, value in sys_.uniforms}
        if uniform_writes:
            uniforms.update(uniform_writes[s])
        sp = ShadeParam(
            position=gbuf.position, normal=gbuf.normal, albedo=gbuf.albedo,
            depth=gbuf.depth, material=gbuf.material, covered=covered,
            base_color=color, camera=camera, lights=lights,
            uniforms=uniforms,
        )
        out = jnp.asarray(sys_.shade(sp), jnp.float32)
        if out.shape != color.shape:
            raise ValueError(
                f"render system {sys_.name!r}: fragment shading returned "
                f"shape {out.shape}, expected {color.shape}")
        color = jnp.where(((px_sys == s) & covered)[..., None], out, color)
    return color


def apply_custom_shading(color, gbuf, winner, batch, world: World, camera,
                         lights, systems: CompiledSystems,
                         draw_ctx) -> jnp.ndarray:
    """Run each shade-fn system's fragment shading over its own pixels.

    Pixel ownership: winner triangle -> entity -> model -> system (the same
    routing the raster used). Pixels of systems without a shade fn keep the
    default deferred result."""
    if systems is None or not systems.has_shade_callbacks():
        return color
    tri_sys = triangle_system_ids(batch, world, systems)
    px_sys = tri_sys[jnp.clip(winner, 0, batch.budget - 1)]
    covered = winner >= 0
    return shade_systems_color(
        color, gbuf, px_sys, covered, camera, lights, systems,
        None if draw_ctx is None else draw_ctx.uniform_writes)


def _system_instance_mask(world: World, system: RenderSystem) -> jnp.ndarray:
    mask = jnp.zeros(world.capacity, bool)
    mid = world["model_id"]
    for m in system.model_ids:
        mask = mask | (mid == m)
    return mask


def _merge_gbuffers(a: GBuffer, b: GBuffer) -> GBuffer:
    """Depth-merge two G-buffers (shared-G-buffer reuse across systems)."""
    closer = (b.tri_id >= 0) & ((b.depth < a.depth) | (a.tri_id < 0))
    cm = closer[..., None]
    return GBuffer(
        depth=jnp.where(closer, b.depth, a.depth),
        position=jnp.where(cm, b.position, a.position),
        normal=jnp.where(cm, b.normal, a.normal),
        albedo=jnp.where(cm, b.albedo, a.albedo),
        material=jnp.where(closer, b.material, a.material),
        tri_id=jnp.where(closer, b.tri_id, a.tri_id),
    )


def render_frame_systems(
    world: World,
    camera,
    bank: ModelBank,
    systems: tuple,
    settings: RenderSettings,
    *,
    cubemap: Optional[jnp.ndarray] = None,
    atlas=None,
    shadow_state=None,
    inputs=None,
) -> jnp.ndarray:
    """Deferred-render with multiple render systems sharing one G-buffer.

    Each system rasters its model set (with its own LoV/unlit knobs); the
    G-buffers depth-merge; one fused lighting pass shades the union; the
    transparency forward pass runs over the union of transparent triangles.
    """
    h, w = settings.height, settings.width
    rasterizer = pick_rasterizer(settings.backend)

    gbuf = None
    unlit_mask = None
    boost = None
    tint_img = None
    sys_img = None
    trans_layers = []
    skybox_on = None
    uniform_values = []
    for s_idx, sys_ in enumerate(systems):
        # per-frame draw callback (DrawParam): the callback's submissions
        # replace static routing, its uniform writes override the compiled
        # constants, and it may toggle the skybox
        writes: dict = {}
        if sys_.draw is not None:
            dp = DrawParam(sys_, world, camera, inputs, bank)
            sys_.draw(dp)
            imask = dp._mask
            writes = dict(dp._uniform_writes)
            if dp.skybox is not None:
                skybox_on = dp.skybox
        else:
            imask = _system_instance_mask(world, sys_)
        uniforms = {name: value for name, value in sys_.uniforms}
        uniforms.update(writes)
        uniform_values.append(uniforms)
        sys_boost_val = jnp.float32(sys_.emissive_boost) * jnp.asarray(
            uniforms.get("emissive_boost", 1.0), jnp.float32)
        sys_tint = jnp.asarray(
            uniforms.get("albedo_tint", (1.0, 1.0, 1.0)),
            jnp.float32).reshape(3)
        alpha_scale = jnp.asarray(uniforms.get("alpha_scale", 1.0),
                                  jnp.float32)

        batch = build_triangle_batch(
            world, bank, camera, max_tris=settings.max_tris,
            instance_mask=imask, apply_lov=sys_.casts_lov,
        )
        batch = to_screen(batch, w, h)
        depth, winner = rasterizer(batch, h, w, settings.raster,
                                   ~batch.transparent)
        g = resolve_gbuffer(batch, bank, depth, winner, atlas=atlas)
        g = dataclasses.replace(g, albedo=g.albedo * sys_tint)
        covered = g.tri_id >= 0
        sys_unlit = jnp.where(covered, not sys_.lit, False)
        sys_boost = jnp.where(covered, sys_boost_val, 1.0)
        sys_tag = jnp.where(covered, s_idx, -1)
        if gbuf is None:
            gbuf, unlit_mask, boost, sys_img = (g, sys_unlit, sys_boost,
                                                sys_tag)
        else:
            closer = covered & ((depth < gbuf.depth) | (gbuf.tri_id < 0))
            unlit_mask = jnp.where(closer, sys_unlit, unlit_mask)
            boost = jnp.where(closer, sys_boost, boost)
            sys_img = jnp.where(closer, sys_tag, sys_img)
            gbuf = _merge_gbuffers(gbuf, g)
        # transparency layer for this system
        t_depth, t_winner = rasterizer(batch, h, w, settings.raster,
                                       batch.transparent)
        with_diss = atlas is not None and bank.has_dissolve_maps()
        if with_diss:
            # dissolve map (map_d): per-pixel alpha on the forward pass
            tg, t_diss = resolve_gbuffer(batch, bank, t_depth, t_winner,
                                         atlas=atlas, with_dissolve=True)
        else:
            tg = resolve_gbuffer(batch, bank, t_depth, t_winner,
                                 atlas=atlas)
            t_diss = None
        tg = dataclasses.replace(tg, albedo=tg.albedo * sys_tint)
        trans_layers.append((s_idx, tg, t_depth, t_winner, alpha_scale,
                             t_diss))

    lights = L.extract_lights(
        world,
        max_dir=settings.max_dir_lights,
        max_point=settings.max_point_lights,
        max_spot=settings.max_spot_lights,
    )
    shadow_factor = None
    if shadow_state is not None:
        from render_engine_tpu.render.shadows import make_shadow_factor

        shadow_factor = make_shadow_factor(
            shadow_state, world,
            {"dir": lights.dir_entity, "spot": lights.sp_entity,
             "point": lights.pt_entity},
        )

    if cubemap is not None:
        dirs = SB.pixel_ray_directions(camera, h, w)
        background = SB.sample_cubemap(cubemap, dirs)
    else:
        background = jnp.broadcast_to(
            jnp.asarray(settings.clear_color, jnp.float32), (h, w, 3)
        )
    if skybox_on is not None:
        # DrawParam.draw_skybox toggle (toggle_rendering_skybox)
        background = jnp.where(
            jnp.asarray(skybox_on, bool), background,
            jnp.asarray(settings.clear_color, jnp.float32))

    color = L.shade(gbuf, lights, bank, camera.position,
                    background=background, shadow_factor=shadow_factor)
    # per-system unlit/emissive-boost override (the light-source draw fn)
    color = jnp.where(unlit_mask[..., None], gbuf.albedo * boost[..., None],
                      color)
    # per-system custom fragment shading over the merged G-buffer (the
    # user shader-body path, same ShadeParam contract as the fast path)
    covered_any = gbuf.tri_id >= 0
    for s_idx, sys_ in enumerate(systems):
        if sys_.shade is None:
            continue
        sp = ShadeParam(
            position=gbuf.position, normal=gbuf.normal, albedo=gbuf.albedo,
            depth=gbuf.depth, material=gbuf.material, covered=covered_any,
            base_color=color, camera=camera, lights=lights,
            uniforms=uniform_values[s_idx],
        )
        out = jnp.asarray(sys_.shade(sp), jnp.float32)
        color = jnp.where(((sys_img == s_idx) & covered_any)[..., None],
                          out, color)

    # transparency: blend each system's transparent layer (back-to-front by
    # merging via depth against the opaque buffer)
    for s_idx, t_gbuf, t_depth, t_winner, alpha_scale, t_diss \
            in trans_layers:
        t_lit = L.shade(t_gbuf, lights, bank, camera.position,
                        background=color, shadow_factor=shadow_factor)
        if systems[s_idx].shade is not None:
            # the user program shades this system's transparent geometry
            # too (the reference's user transparency draw runs through the
            # same generated program, render_system.rs:501)
            t_cov = t_gbuf.tri_id >= 0
            sp_t = ShadeParam(
                position=t_gbuf.position, normal=t_gbuf.normal,
                albedo=t_gbuf.albedo, depth=t_gbuf.depth,
                material=t_gbuf.material, covered=t_cov,
                base_color=t_lit, camera=camera, lights=lights,
                uniforms=uniform_values[s_idx],
            )
            out_t = jnp.asarray(systems[s_idx].shade(sp_t), jnp.float32)
            t_lit = jnp.where(t_cov[..., None], out_t, t_lit)
        mat = jnp.clip(t_gbuf.material, 0, bank.mat_alpha.shape[0] - 1)
        alpha = jnp.clip(bank.mat_alpha[mat][..., None] * alpha_scale,
                         0.0, 1.0)
        if t_diss is not None:
            alpha = alpha * t_diss[..., None]
        in_front = (t_winner >= 0) & (t_depth <= gbuf.depth)
        color = jnp.where(in_front[..., None],
                          alpha * t_lit + (1.0 - alpha) * color, color)

    return jnp.clip(color, 0.0, 1.0)
