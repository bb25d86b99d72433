"""The Engine: owns world/camera/bank, drives jitted frame steps.

Replaces launch_render_system + the render thread's frame loop
(src/lib.rs:43-186, src/threads/render_thread.rs:46-251). One host loop, two
jitted functions:

  * ``step``          — the logic tick (logic/step.py)
  * ``step_and_render`` — tick + deferred render fused in one XLA program

History recording happens host-side per frame (the history thread's job —
here a list append; XLA async dispatch provides the pipelining the condvar
double-buffer provided). Crash-safe flushing lives in runtime/supervisor.py.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

from render_engine_tpu.ecs import world as W
from render_engine_tpu.logic.step import (make_step, pack_drop_stats,
                                          unpack_drop_stats)
from render_engine_tpu.logic.types import InputState
from render_engine_tpu.math.camera import Camera, CameraBuilder
from render_engine_tpu.models.bank import ModelBank, ModelBankBuilder
from render_engine_tpu.render.frame import render_frame
from render_engine_tpu.runtime.config import EngineConfig
from render_engine_tpu.runtime.history import HistoryLog
from render_engine_tpu.math import transforms as T


class Engine:
    def __init__(self, config: EngineConfig, camera: Camera | None = None):
        self.config = config
        self.world_config = W.WorldConfig(
            capacity=config.capacity,
            world_min=config.world_min,
            world_length=config.world_length,
            section_length=config.section_length,
            registry=config.registry,
        )
        # packed-boundary state (activated at finalize_scene): the camera's
        # dynamic state crosses jit boundaries as ONE (8,) vector and the
        # shadow state's five small fields as two leaves — every leaf is
        # its own buffer handle with its own dispatch cost per donated
        # in+out pair. The .camera /
        # .shadow_state properties below unpack lazily for host reads.
        # (Packing the WORLD the same way was measured SLOWER — the
        # boundary tables materialize in addition to the column views the
        # frame consumes; see CLAUDE.md dead ends.)
        self._camvec = None
        self._cam_template = None
        self._camera_cache = None
        self._camera_raw = None
        self._shtabs = None
        self._sh_template = None
        self._shadow_cache = None
        self._shadow_raw = None
        self.world = W.create_world(self.world_config)
        self.camera = camera or CameraBuilder().build()
        self.bank_builder = (
            ModelBankBuilder(lov_fractions=tuple(config.lov_fractions))
            if config.lov_fractions is not None else ModelBankBuilder())
        self.bank: ModelBank | None = None
        self.cubemap = None
        self.atlas = None
        self.shadow_state = None
        self.history = HistoryLog()
        self.frame_index = 0
        import numpy as np
        from render_engine_tpu.logic.types import NUM_KEYS

        self._prev_keys = np.zeros(NUM_KEYS, bool)
        self._last_drops = None  # device-side budget-overflow counters
        self._step = None
        self._step_render = None
        self._frame_times: list[float] = []

        if config.build_scene is not None:
            config.build_scene(self)
        self.finalize_scene()

    # -- packed-boundary properties ------------------------------------------
    # Before finalize_scene the raw objects are the truth; after it, the
    # packed vectors are — reads rebuild the dataclass lazily (memoized
    # until the next frame), writes repack. Bit-exact both ways.
    @staticmethod
    def _cam_meta(cam: Camera):
        return (cam.fov_y, cam.aspect, cam.near, cam.far,
                cam.draw_distance, cam.projection_kind,
                cam.ortho_half_extent, cam.movement_factor)

    @property
    def camera(self) -> Camera:
        if self._camvec is None:
            return self._camera_raw
        if self._camera_cache is None:
            self._camera_cache = self._cam_template.apply_serialized(
                self._camvec)
        return self._camera_cache

    @camera.setter
    def camera(self, value: Camera):
        if self._cam_template is None:
            self._camera_raw = value
            return
        import numpy as np

        rebuild = self._cam_meta(value) != self._cam_meta(self._cam_template)
        self._cam_template = value
        self._camvec = np.asarray(value.serialize(), np.float32)
        self._camera_cache = value
        if rebuild:
            # the camera's static config is baked into the compiled
            # programs as trace-time constants; changing it forces fresh
            # traces — the same recompile a changed pytree treedef caused
            # when the Camera crossed the boundary as a dataclass
            self._build_step_programs()
            self._build_render()

    @property
    def shadow_state(self):
        if self._shtabs is None:
            return self._shadow_raw
        if self._shadow_cache is None:
            from render_engine_tpu.render import shadows as SH

            self._shadow_cache = SH.unpack_shadow_state(
                *self._shtabs, self._sh_template)
        return self._shadow_cache

    @shadow_state.setter
    def shadow_state(self, value):
        if self._sh_template is None or value is None:
            self._shadow_raw = value
            if value is None:
                self._shtabs = None
                self._shadow_cache = None
            return
        from render_engine_tpu.render import shadows as SH

        # the value carries the static config too (slot budget,
        # resolution, pcf_scale) — keep the unpack template fresh
        self._sh_template = value
        self._shtabs = tuple(SH.pack_shadow_state(value))
        self._shadow_cache = value

    def _install_frame_state(self, camv, shtabs=None):
        """Adopt a frame program's returned packed camera/shadow state and
        invalidate the lazy views."""
        self._camvec = camv
        self._camera_cache = None
        if shtabs is not None:
            self._shtabs = tuple(shtabs)
            self._shadow_cache = None

    # -- scene setup -------------------------------------------------------
    def spawn(self, count: int, **components):
        """Host-side instance registration (pipeline.rs:186-208)."""
        self.world, idx = W.spawn_host(self.world, count, **components)
        return idx

    def set_skybox(self, cubemap):
        self.cubemap = cubemap

    def set_atlas(self, atlas):
        self.atlas = atlas

    def set_render_systems(self, systems):
        """Bind user render systems (a tuple of render_system.RenderSystem
        or a callable (bank) -> tuple, compiled at finalize_scene)."""
        self.config.render_systems = systems

    def finalize_scene(self):
        """Freeze the model bank, refresh transforms, snapshot the history
        baseline, and build the jitted step functions."""
        if self.bank is None:
            if not self.bank_builder._models:
                # ensure a non-empty bank (a unit cube placeholder)
                from render_engine_tpu.models import primitives

                self.bank_builder.add_model("__placeholder__",
                                            primitives.cube(1.0))
            self.bank = self.bank_builder.finalize()

        from render_engine_tpu.logic import kinematics as K

        self.world = K.refresh_transforms(
            self.world, self.bank.aabb_min, self.bank.aabb_max,
            jnp.asarray(self.world.alive),
        )
        if self.config.record_history:
            self.history.set_baseline(
                self.world, self.camera,
                meta={"engine": "render_engine_tpu",
                      "capacity": self.config.capacity},
            )

        self._step_fn = make_step(
            tuple(self.config.entity_types),
            logic_radius=self.config.logic_radius,
            spawn_budget=self.config.spawn_budget,
            collision_budget=self.config.collision_budget,
            collision_pairs=self.config.collision_pairs,
            collision_large_budget=self.config.collision_large_budget,
            with_stats=True,
        )
        bank = self.bank

        # compile user render systems to per-model routing + shading tables
        # (the RenderSystemBuilder -> create_render_system step,
        # initialize_logic.rs:137-185, minus the GLSL codegen)
        self.compiled_systems = None
        rs = self.config.render_systems
        if rs is not None:
            from render_engine_tpu.render.render_system import compile_systems

            if callable(rs):
                rs = rs(bank)
            self.compiled_systems = compile_systems(tuple(rs), bank)

        if self.config.enable_shadows:
            from render_engine_tpu.render import shadows as SH

            self.shadow_state = SH.create_shadow_state(
                self.config.shadow_resolution,
                budget=self.config.shadow_slots,
                pcf_scale=self.config.shadow_pcf_scale,
            )

        # activate the packed camera/shadow boundary (properties above) —
        # idempotent: a re-finalize (benchmarks rebuild jit fns through
        # finalize_scene) reads the current state back through the
        # properties and repacks it
        import numpy as np

        cam = self.camera
        self._cam_template = cam
        self._camvec = np.asarray(cam.serialize(), np.float32)
        self._camera_cache, self._camera_raw = cam, None
        sh = self.shadow_state
        if sh is not None:
            from render_engine_tpu.render import shadows as SH

            self._sh_template = sh
            self._shtabs = tuple(SH.pack_shadow_state(sh))
            self._shadow_cache, self._shadow_raw = sh, None
        else:
            self._sh_template = None
            self._shtabs = None
            self._shadow_cache = None

        self._build_step_programs()
        self._build_render()

    def _build_step_programs(self):
        """(Re)jit the step-only programs. Re-run (with _build_render) when
        the camera's static config changes — see the camera setter."""
        step = self._step_fn
        bank = self.bank
        cam_template = self._cam_template

        # every jitted program takes ONE packed f32 input vector instead of
        # (keys, mouse, seed, prev_keys, dt): each small host array is its
        # own host->device transfer with its own dispatch latency
        # (InputState.pack_with_dt)
        def step_only(world, camv, packed):
            camera = cam_template.apply_serialized(camv)
            inputs, dt = InputState.unpack_with_dt(packed)
            world, camera, stats = step(world, camera, inputs, dt,
                                        bank.aabb_min, bank.aabb_max)
            # counters ride ONE stacked vector (one output buffer handle
            # instead of six; unpacked lazily in drop_stats)
            return world, camera.serialize(), pack_drop_stats(stats)

        # BIT-DETERMINISM INVARIANT: live and replay advance world state
        # through the IDENTICAL compiled-program sequence. Two advance
        # programs exist — this standalone step (headless frames) and the
        # fused step+shadow+render frame program (rendered frames); the
        # two may round differently (different XLA programs), so each
        # recorded frame stores WHICH one advanced it and the Player
        # replays that exact choice. See docs/playback.md.
        self._step = jax.jit(step_only, donate_argnums=(0,))

        def step_many(world, camv, packed_batch):
            """lax.scan over a batch of frames — ONE dispatch for N steps.

            Amortizes host->device latency for headless/bench runs. NOTE:
            this is a different compiled program than the single step; runs
            that must be bit-replayable frame-by-frame use frame()/_step.
            Drop counters are the per-counter MAX over the whole burst (a
            mid-burst overflow must not vanish by the last frame — the
            ALL-truncation-counted contract)."""
            camera = cam_template.apply_serialized(camv)

            def body(carry, row):
                w, c = carry
                inp, dt = InputState.unpack_with_dt(row)
                w, c, stats = step(w, c, inp, dt, bank.aabb_min,
                                   bank.aabb_max)
                return (w, c), pack_drop_stats(stats)

            (world, camera), drops_seq = jax.lax.scan(
                body, (world, camera), packed_batch
            )
            return (world, camera.serialize(),
                    jnp.max(drops_seq, axis=0))

        self._step_many = jax.jit(step_many, donate_argnums=(0,))

    def _build_render(self):
        """(Re)jit the render program from the current settings. Window /
        resolution changes only touch this — the step program (and so the
        replayed trajectory) is untouched."""
        bank = self.bank
        settings = self.config.render
        cubemap = self.cubemap
        atlas = self.atlas
        systems = self.compiled_systems
        sh_template = self._sh_template

        def render_pure(world, camera, shtabs=None, packed=None):
            # read-only render: the camera stays a PYTREE here so detached-
            # flight cameras with different static config retrace instead
            # of silently inheriting the engine template's constants
            from render_engine_tpu.render import shadows as SH

            shadow_state = (None if shtabs is None else
                            SH.unpack_shadow_state(*shtabs, sh_template))
            inputs = (None if packed is None
                      else InputState.unpack_with_dt(packed)[0])
            return render_frame(world, camera, bank, settings, cubemap=cubemap,
                                atlas=atlas, shadow_state=shadow_state,
                                systems=systems, inputs=inputs)

        self._render = jax.jit(render_pure)

        if self.config.enable_shadows:
            from render_engine_tpu.render import shadows as SH

            shadow_tris = self.config.shadow_max_tris
            shadow_ivl = self.config.shadow_update_interval
            shadow_lov = self.config.shadow_lov_bias

            def render_shadowed(world, camera, shtabs, packed=None):
                shadow_state = SH.unpack_shadow_state(*shtabs, sh_template)
                inputs = (None if packed is None
                          else InputState.unpack_with_dt(packed)[0])
                # the frame's single shadow-map update (<=1 new map,
                # shadow_flow.rs:111-133) rides in the SAME program as the
                # render: one dispatch, and XLA schedules the shadow raster
                # alongside the frame's other work. Shadow maps are derived
                # caches outside the replayed state, so this never touches
                # the step program's determinism.
                shadow_state = SH.render_shadow_map(
                    shadow_state, world, camera, bank, max_tris=shadow_tris,
                    interval=shadow_ivl, lov_bias=shadow_lov,
                    caster_mask=self.config.shadow_caster_mask)
                img = render_frame(world, camera, bank, settings,
                                   cubemap=cubemap, atlas=atlas,
                                   shadow_state=shadow_state,
                                   systems=systems, inputs=inputs)
                return img, SH.pack_shadow_state(shadow_state)

            self._render_shadowed = jax.jit(render_shadowed,
                                            donate_argnums=(2,))

        # the one-dispatch frame program: step + shadow update + render in
        # a single XLA program (halves the per-frame host dispatch cost).
        # Rendered frames — recorded OR
        # not — advance through it; recorded frames store the choice so
        # replay re-drives the same binary (determinism note above).
        step_fn = self._step_fn

        if self.config.enable_shadows:
            from render_engine_tpu.render import shadows as SH

            shadow_tris = self.config.shadow_max_tris
            shadow_ivl = self.config.shadow_update_interval
            shadow_lov = self.config.shadow_lov_bias

            cam_template = self._cam_template

            def frame_fused(world, camv, shtabs, packed):
                camera = cam_template.apply_serialized(camv)
                shadow_state = SH.unpack_shadow_state(*shtabs, sh_template)
                inputs, dt = InputState.unpack_with_dt(packed)
                world, camera, stats = step_fn(
                    world, camera, inputs, dt, bank.aabb_min, bank.aabb_max)
                drops = pack_drop_stats(stats)
                shadow_state = SH.render_shadow_map(
                    shadow_state, world, camera, bank, max_tris=shadow_tris,
                    interval=shadow_ivl, lov_bias=shadow_lov,
                    caster_mask=self.config.shadow_caster_mask)
                img = render_frame(world, camera, bank, settings,
                                   cubemap=cubemap, atlas=atlas,
                                   shadow_state=shadow_state,
                                   systems=systems, inputs=inputs)
                return (world, camera.serialize(), drops,
                        SH.pack_shadow_state(shadow_state), img)

            self._frame_fused = jax.jit(frame_fused, donate_argnums=(0, 2))
        else:
            cam_template = self._cam_template

            def frame_fused_ns(world, camv, packed):
                camera = cam_template.apply_serialized(camv)
                inputs, dt = InputState.unpack_with_dt(packed)
                world, camera, stats = step_fn(
                    world, camera, inputs, dt, bank.aabb_min, bank.aabb_max)
                drops = pack_drop_stats(stats)
                img = render_frame(world, camera, bank, settings,
                                   cubemap=cubemap, atlas=atlas,
                                   systems=systems, inputs=inputs)
                return world, camera.serialize(), drops, img

            self._frame_fused = jax.jit(frame_fused_ns, donate_argnums=(0,))

        # scan-batched rendered frames for UNRECORDED headless runs: ONE
        # dispatch steps+shadows+renders N frames back-to-back (every frame
        # is fully rendered; only the last image survives the carry). This
        # removes the per-frame host->device dispatch latency that even
        # async dispatch doesn't hide —
        # the analogue of the reference's frames-in-flight pipelining
        # (mapped_buffer.rs fences). Recorded runs never take this path.
        has_shadows = self.config.enable_shadows
        if has_shadows:
            from render_engine_tpu.render import shadows as SH2
        cam_template2 = self._cam_template

        def frames_scan(world, camv, shtabs, packed_batch):
            camera = cam_template2.apply_serialized(camv)
            shadow_state = (SH2.unpack_shadow_state(*shtabs, sh_template)
                            if has_shadows else None)

            def body(carry, row):
                w, c, sh, _ = carry
                inp, dt = InputState.unpack_with_dt(row)
                w, c, stats = step_fn(w, c, inp, dt, bank.aabb_min,
                                      bank.aabb_max)
                drops = pack_drop_stats(stats)
                if has_shadows:
                    sh = SH2.render_shadow_map(
                        sh, w, c, bank, max_tris=self.config.shadow_max_tris,
                        interval=self.config.shadow_update_interval,
                        lov_bias=self.config.shadow_lov_bias,
                        caster_mask=self.config.shadow_caster_mask)
                img = render_frame(w, c, bank, settings, cubemap=cubemap,
                                   atlas=atlas, shadow_state=sh,
                                   systems=systems, inputs=inp)
                return (w, c, sh, img), drops

            init_img = jnp.zeros((settings.height, settings.width, 3),
                                 jnp.float32)
            (world, camera, shadow_state, img), drops_seq = jax.lax.scan(
                body, (world, camera, shadow_state, init_img),
                packed_batch)
            # per-counter MAX over the burst (same contract as step_many:
            # a mid-burst overflow must not vanish by the last frame)
            out_sh = (SH2.pack_shadow_state(shadow_state) if has_shadows
                      else shadow_state)
            return (world, camera.serialize(), out_sh, img,
                    jnp.max(drops_seq, axis=0))

        self._frames_scan = jax.jit(frames_scan, donate_argnums=(0, 2))

        # host-side snapshot of the freshly-finalized state: reset() returns
        # to frame zero WITHOUT re-tracing the jitted programs (host copies
        # because _step/_frame_fused/_frames_scan donate their device
        # buffers, which would invalidate stashed device references)
        import numpy as np

        import jax.tree_util as jtu

        self._initial_state = jtu.tree_map(
            np.asarray, (self.world, self.camera, self.shadow_state))

    def reset(self):
        """Return to the post-finalize_scene initial state (frame zero,
        fresh history baseline) while keeping every compiled program.

        A full engine build re-traces step+render — minutes on CPU — so
        session-scoped test engines reset() between cases instead. Config
        mutated mid-run (set_window / set_draw_distances) is NOT restored;
        tests that change it take a dedicated engine."""
        import numpy as np

        import jax.tree_util as jtu

        from render_engine_tpu.logic.types import NUM_KEYS

        w0, c0, s0 = self._initial_state
        self.world = jtu.tree_map(jnp.asarray, w0)
        self.camera = jtu.tree_map(jnp.asarray, c0)
        self.shadow_state = jtu.tree_map(jnp.asarray, s0)
        self.history = HistoryLog()
        if self.config.record_history:
            self.history.set_baseline(
                self.world, self.camera,
                meta={"engine": "render_engine_tpu",
                      "capacity": self.config.capacity},
            )
        self.frame_index = 0
        self._prev_keys = np.zeros(NUM_KEYS, bool)
        self._frame_times = []
        self._last_drops = None

    # -- mid-run config changes (recorded; replay applies them at the same
    # frame — FrameChange::DrawDistancesChange / WindowDimensionsChange,
    # public_common_structures.rs:7-16) ------------------------------------
    def apply_config_event(self, event: dict):
        import dataclasses as dc

        cam_keys = {k: float(v) for k, v in event.items()
                    if k in ("draw_distance", "near", "far", "fov_y")}
        if cam_keys:
            self.camera = dc.replace(self.camera, **cam_keys)
        if "window" in event:
            w, h = (int(v) for v in event["window"])
            self.config.render = dc.replace(self.config.render,
                                            width=w, height=h)
            self.camera = dc.replace(self.camera, aspect=w / h)
            self._build_render()

    def set_draw_distances(self, *, draw_distance=None, near=None, far=None,
                           fov_y=None):
        """Change camera draw distances mid-run; recorded so playback
        reproduces the change at the same frame."""
        ev = {k: float(v) for k, v in (
            ("draw_distance", draw_distance), ("near", near), ("far", far),
            ("fov_y", fov_y)) if v is not None}
        self.apply_config_event(ev)
        if self.config.record_history:
            self.history.record_event(ev)

    def set_window(self, width: int, height: int):
        """Change the render resolution mid-run (recorded). Re-jits only
        the render program — the step trajectory is unaffected."""
        ev = {"window": [int(width), int(height)]}
        self.apply_config_event(ev)
        if self.config.record_history:
            self.history.record_event(ev)

    # -- frame loop --------------------------------------------------------
    def frame(self, inputs: InputState | None = None, dt: float = 1.0 / 60.0,
              render: bool = True, advance: str | None = None):
        """Advance one frame. Returns the rendered image (or None).

        ``advance``: which compiled program advances the state —
        ``"fused"`` (the one-dispatch step+shadow+render frame program) or
        ``"step"`` (the standalone step, plus a separate render dispatch
        when ``render``). ``None`` picks fused whenever rendering. The
        BIT-DETERMINISM INVARIANT is that live and replay drive the
        IDENTICAL compiled-program sequence: recorded frames store their
        advance choice in the history, and the Player passes it back here
        verbatim — so recorded rendered frames run at full fused headline
        speed and still replay bit-exactly (see docs/playback.md)."""
        inputs = inputs if inputs is not None else InputState.idle(
            seed=self.frame_index)
        if advance is None:
            use_fused = bool(render)
        else:
            assert advance in ("fused", "step"), advance
            use_fused = advance == "fused"
        if self.config.record_history:
            self.history.record_frame(inputs, dt, fused=use_fused)
        # InputHistory: thread last frame's key state through (derived from
        # the stream, so replay reconstructs it identically)
        inputs = inputs.with_prev(self._prev_keys)
        self._prev_keys = inputs.keys
        t0 = time.perf_counter()
        img = None
        packed = inputs.pack_with_dt(dt)  # ONE host->device transfer
        if use_fused:
            # ONE dispatch: step + shadow update + render. A replayed
            # fused frame re-runs this same program even when the caller
            # asked for no image (the state must advance through the
            # recorded binary; the image is simply not returned).
            if self._shtabs is not None:
                (self.world, camv, self._last_drops,
                 shtabs, img) = self._frame_fused(
                    self.world, self._camvec, self._shtabs, packed)
                self._install_frame_state(camv, shtabs)
            else:
                (self.world, camv, self._last_drops,
                 img) = self._frame_fused(
                    self.world, self._camvec, packed)
                self._install_frame_state(camv)
            if not render:
                img = None
        else:
            self.world, camv, self._last_drops = self._step(
                self.world, self._camvec, packed)
            self._install_frame_state(camv)
            if render:
                if self._shtabs is not None:
                    img, shtabs = self._render_shadowed(
                        self.world, self.camera, self._shtabs, packed)
                    self._install_frame_state(self._camvec, shtabs)
                else:
                    img = self._render(self.world, self.camera,
                                       packed=packed)
        self.frame_index += 1
        self._frame_times.append(time.perf_counter() - t0)
        return img

    def _pack_batch(self, inputs_list, dts):
        """Chain prev_keys through the batch and pack each frame's inputs
        into one row of a single (N, PACKED_INPUT_LEN) host array — one
        transfer for the whole burst."""
        import numpy as np

        assert len(inputs_list) == len(dts), (len(inputs_list), len(dts))
        rows = []
        prev = self._prev_keys
        for inp, dt in zip(inputs_list, dts):
            rows.append(inp.with_prev(prev).pack_with_dt(dt))
            prev = inp.keys
        self._prev_keys = prev
        return np.stack(rows)

    def run_frames(self, inputs_list, dts, render_last: bool = False):
        """Advance many frames in one device dispatch (scan). Returns the
        last frame's image if requested. Not for replay-recorded runs —
        see step_many's determinism note."""
        packed_batch = self._pack_batch(inputs_list, dts)
        self.world, camv, self._last_drops = self._step_many(
            self.world, self._camvec, packed_batch)
        self._install_frame_state(camv)
        self.frame_index += len(dts)
        if render_last:
            # advance the shadow round-robin by one map so the rendered
            # frame isn't N frames stale (full freshness needs the
            # per-frame paths: frame() or run_frames_rendered)
            if self._shtabs is not None:
                img, shtabs = self._render_shadowed(
                    self.world, self.camera, self._shtabs)
                self._install_frame_state(self._camvec, shtabs)
                return img
            return self.render_only()
        return None

    def run_frames_rendered(self, inputs_list, dts):
        """Advance AND fully render many frames in one device dispatch
        (scan over the fused step+shadow+render body). Returns the last
        frame's image. Only for unrecorded runs — recorded state must
        advance through the standalone _step program (see the determinism
        note in finalize_scene)."""
        assert not self.config.record_history, (
            "run_frames_rendered is for unrecorded runs; recorded runs "
            "must step through the one compiled _step program")
        packed_batch = self._pack_batch(inputs_list, dts)
        t0 = time.perf_counter()
        (self.world, camv, shtabs, img,
         self._last_drops) = self._frames_scan(
            self.world, self._camvec, self._shtabs, packed_batch)
        self._install_frame_state(camv, shtabs)
        self.frame_index += len(inputs_list)
        per = (time.perf_counter() - t0) / len(inputs_list)
        self._frame_times.extend([per] * len(inputs_list))
        return img

    def render_only(self, camera=None):
        """Render the current state without stepping (detached-camera
        replay views, debug HUD)."""
        cam = camera if camera is not None else self.camera
        if self._shtabs is not None:
            return self._render(self.world, cam, self._shtabs)
        return self._render(self.world, cam)

    # -- stats -------------------------------------------------------------
    def fps_stats(self) -> dict:
        """Host-observed dispatch times (frame wall-time print analogue,
        pipeline.rs:214,273)."""
        if not self._frame_times:
            return {}
        import numpy as np

        ts = np.asarray(self._frame_times[1:] or self._frame_times)
        out = {
            "frames": len(self._frame_times),
            "mean_ms": float(ts.mean() * 1e3),
            "p50_ms": float(np.percentile(ts, 50) * 1e3),
            "fps": float(1.0 / max(ts.mean(), 1e-9)),
        }
        out["drops"] = self.drop_stats()
        return out

    def drop_stats(self) -> dict:
        """Budget-overflow counters: the engine's conservatism made
        observable (the reference's soft-error prints, texture_array.rs:91,
        mapped_buffer.rs:171-181). Step counters come from the last frame
        (device values read back here, on demand); render counters run a
        small diagnostic jit over the current state."""
        out = {}
        if self._last_drops is not None:
            out.update(unpack_drop_stats(self._last_drops))
        out.update(self.render_drop_stats())
        return out

    def render_drop_stats(self) -> dict:
        """Triangle-budget + tile-candidate overflow for the current state
        (diagnostic jit, not part of the frame hot path)."""
        if self.bank is None:
            return {}
        if not hasattr(self, "_render_diag"):
            bank = self.bank
            settings = self.config.render
            systems = self.compiled_systems
            atlas = self.atlas

            def diag(world, camera, shadow_state):
                from render_engine_tpu.render import raster_pallas as RP
                from render_engine_tpu.render.frame import (
                    shadow_tile_overflow,
                )
                from render_engine_tpu.render.geometry import (
                    build_triangle_batch,
                    to_screen,
                )

                batch = build_triangle_batch(
                    world, bank, camera, max_tris=settings.max_tris,
                    systems=systems)
                batch = to_screen(batch, settings.width, settings.height)
                cfg = settings.raster
                tiles_x = -(-settings.width // cfg.tile_w)
                tiles_y = -(-settings.height // cfg.tile_h)
                tri_class = jnp.where(
                    batch.valid,
                    jnp.where(batch.transparent, 2.0, 1.0), 0.0,
                ).astype(jnp.float32)
                from render_engine_tpu.render.raster_jnp import _bin_triangles

                cand, counts = RP._candidate_table(
                    batch, cfg, tiles_x, tiles_y, tri_class)
                _, _, _, _, cand_dropped = _bin_triangles(
                    batch, cfg, tiles_x, tiles_y, tri_class)
                tri_dropped = jnp.maximum(
                    batch.total_requested - settings.max_tris, 0)
                out = {"triangle_budget_dropped": tri_dropped,
                       "tile_candidate_dropped": cand_dropped}
                from render_engine_tpu.render.frame import pick_rasterizer
                from render_engine_tpu.render.raster_pallas import (
                    rasterize_depth_winner_pallas,
                )

                tiled_path = (pick_rasterizer(settings.backend)
                              is rasterize_depth_winner_pallas)
                if atlas is not None and tiled_path:
                    # textured-candidate tiles beyond texture_tile_budget
                    # degrade to solid albedo; count them (conservative:
                    # candidate-level superset of textured winners). Only
                    # the tiled Pallas path applies this budget — the jnp
                    # path samples the atlas per pixel, so counting there
                    # would report truncation that never happened.
                    nt_ = tiles_x * tiles_y
                    ttb = max(1, int(round(
                        nt_ * settings.texture_tile_budget)))
                    tri_tex = (bank.mat_texture[jnp.clip(
                        batch.material, 0,
                        bank.mat_texture.shape[0] - 1)] >= 0) & batch.valid
                    tex_cand = jnp.any(
                        (cand >= 0)
                        & tri_tex[jnp.clip(cand, 0, batch.budget - 1)],
                        axis=1)
                    out["texture_tile_overflow"] = jnp.maximum(
                        jnp.sum(tex_cand.astype(jnp.int32)) - ttb, 0)
                if settings.light_tile_budget > 0 and tiled_path:
                    # per-tile light-list overflow: the selection is
                    # depth-independent, so this reproduces the render
                    # pass's exact counts
                    from render_engine_tpu.render import lighting as LG
                    from render_engine_tpu.render.shade_pallas import (
                        pack_lights,
                        select_tile_lights,
                    )

                    lights = LG.extract_lights(
                        world, max_dir=settings.max_dir_lights,
                        max_point=settings.max_point_lights,
                        max_spot=settings.max_spot_lights)
                    lbud = (settings.max_dir_lights
                            + settings.max_point_lights
                            + settings.max_spot_lights)
                    ltab_sel, n_live = pack_lights(lights, lbud)
                    inv_pv_l = T.inv44(camera.proj_view())
                    _, _, light_drop = select_tile_lights(
                        ltab_sel, n_live, camera.position, inv_pv_l,
                        tiles_x, tiles_y, cfg.tile_h, cfg.tile_w,
                        settings.width, settings.height, 0.0,
                        settings.light_tile_budget)
                    out["light_tile_overflow"] = light_drop
                if shadow_state is not None:
                    # shadow-pass triangle budget overflow: rebuild the
                    # depth-only batch the NEXT update would rasterize
                    # (same choose_light schedule) and count the excess
                    from render_engine_tpu.render import shadows as SHD

                    _, _, slight, sface, sdo = SHD.choose_light(
                        shadow_state, world, camera.position)
                    spv = SHD.light_proj_view(world, slight, face=sface)
                    cmask = self.config.shadow_caster_mask
                    if callable(cmask):
                        cmask = cmask(world)
                    sbatch = build_triangle_batch(
                        world, bank, camera,
                        max_tris=self.config.shadow_max_tris,
                        apply_lov=True, proj_view=spv, depth_only=True,
                        lov_bias=self.config.shadow_lov_bias,
                        instance_mask=cmask)
                    out["shadow_triangle_dropped"] = jnp.maximum(
                        sbatch.total_requested
                        - self.config.shadow_max_tris, 0)
                    # casters the (light-fitted) shadow camera cannot see —
                    # nonzero means silent missing shadows (gated on an
                    # actually-scheduled light; slight is junk otherwise)
                    out["shadow_caster_outside_volume"] = jnp.where(
                        sdo, SHD.casters_outside_volume(world, slight, spv),
                        0)
                    # binning overflow of the shadow raster itself (same
                    # config the pass runs with — shadow_raster_cfg)
                    scfg = SHD.shadow_raster_cfg(self.config.shadow_max_tris)
                    res = self.config.shadow_resolution
                    sb2 = to_screen(sbatch, res, res)
                    s_tx = -(-res // scfg.tile_w)
                    s_ty = -(-res // scfg.tile_h)
                    _, _, _, s_cand_dropped = _bin_triangles(
                        sb2, scfg, s_tx, s_ty)
                    out["shadow_tile_candidate_dropped"] = s_cand_dropped
                if shadow_state is not None:
                    # true per-slot PCF overflow: raster the frame's depth
                    # and count frustum-needed tiles beyond the budget
                    d, wn, *_ = RP._launch(
                        batch, settings.height, settings.width, cfg,
                        tri_class, two_pass=True, cand=cand, counts=counts)
                    inv_pv = T.inv44(camera.proj_view())
                    out["shadow_tile_overflow"] = shadow_tile_overflow(
                        shadow_state, d, wn, tiles_x, cfg.tile_h,
                        cfg.tile_w, settings.width, settings.height,
                        inv_pv, 0.0, settings.shadow_tile_budget)
                return out

            self._render_diag = jax.jit(diag, static_argnums=())
        vals = self._render_diag(self.world, self.camera, self.shadow_state)
        return {k: int(v) for k, v in vals.items()}

    def flush_history(self) -> str | None:
        if self.config.record_history:
            return self.history.write_to_disk(self.config.history_dir)
        return None
