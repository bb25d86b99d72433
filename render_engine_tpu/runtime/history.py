"""Record/replay history: baseline snapshot + per-frame input log.

The reference's signature feature (README.md:30-37): every frame's state
changes stream to a history thread and flush to disk on exit or crash, then
replay deterministically. Its wire format is a baseline bincode(ECS) +
bincode(tree) plus per-frame FrameChange deltas with a byte-length index
(src/threads/history_thread.rs:150-205, game_loader.rs:27-72).

Array-native redesign (SURVEY.md section 7): because the step is a pure
function, recording the *inputs* is enough — baseline snapshot (world pytree
+ camera + settings) plus the per-frame (InputState, dt) stream reproduces
every state bit-for-bit by re-running the step. This is strictly stronger
than the reference (which must record outputs of nondeterministic logic):
our nondeterminism is seeded from the recorded per-frame rng seed.

On-disk format: one ``.npz`` holding the snapshot leaves + an (N, F) input
matrix + (N,) dt vector + camera baseline — the analogue of
gameplay_history.txt / gameplay_byte_lookup.txt / initial_camera.txt.
"""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np

from render_engine_tpu.ecs import world as W
from render_engine_tpu.logic.types import InputState

FORMAT_VERSION = 2  # v2 adds the per-frame advance-program flag


class HistoryLog:
    """Host-side accumulation of the frame input stream."""

    def __init__(self):
        self.baseline_world: dict | None = None
        self.baseline_camera: np.ndarray | None = None
        self.frames_inputs: list[np.ndarray] = []
        self.frames_dt: list[float] = []
        # per-frame advance program: True = the fused step+shadow+render
        # frame program, False = the standalone step program. Replay must
        # drive the IDENTICAL compiled program per frame (the
        # bit-determinism invariant, docs/playback.md) — recording the
        # choice is what lets rendered recorded frames take the fused
        # one-dispatch path at full headline speed.
        self.frames_fused: list[bool] = []
        self.meta: dict = {}
        # mid-recording config-change events, keyed by the frame index they
        # precede (FrameChange::DrawDistancesChange / WindowDimensionsChange,
        # reference src/threads/public_common_structures.rs:7-16)
        self.events: dict = {}

    # -- recording ---------------------------------------------------------
    def set_baseline(self, world, camera, meta: dict | None = None):
        """Snapshot at init — synchronize_state (pipeline.rs:120-123)."""
        self.baseline_world = W.snapshot(world)
        self.baseline_camera = np.asarray(camera.serialize())
        self.meta = dict(meta or {})

    def record_frame(self, inputs: InputState, dt: float,
                     fused: bool = False):
        self.frames_inputs.append(np.asarray(inputs.serialize()))
        self.frames_dt.append(float(dt))
        self.frames_fused.append(bool(fused))

    def record_event(self, event: dict):
        """Record a config change to apply before the NEXT recorded frame
        (draw distances, window dimensions)."""
        self.events.setdefault(self.num_frames, {}).update(event)

    @property
    def num_frames(self) -> int:
        return len(self.frames_dt)

    # -- disk --------------------------------------------------------------
    def write_to_disk(self, directory: str):
        """Flush — write_to_disk (history_thread.rs:150-205), including the
        retry-once-on-failure behaviour (:160-173)."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "gameplay_history.npz")
        payload = {
            "version": np.int32(FORMAT_VERSION),
            "camera": self.baseline_camera,
            "inputs": np.stack(self.frames_inputs)
            if self.frames_inputs
            else np.zeros((0, 19), np.float32),
            "dt": np.asarray(self.frames_dt, np.float32),
            "fused": np.asarray(self.frames_fused, np.uint8),
            "alive": self.baseline_world["alive"],
            "comp_mask": self.baseline_world["comp_mask"],
        }
        for k, v in self.baseline_world["comps"].items():
            payload[f"comp_{k}"] = v
        for attempt in range(2):
            try:
                with open(path, "wb") as f:
                    np.savez_compressed(f, **payload)
                break
            except OSError:
                if attempt == 1:
                    raise
        with open(os.path.join(directory, "history_meta.json"), "w") as f:
            json.dump({"version": FORMAT_VERSION,
                       "num_frames": self.num_frames,
                       "events": {str(k): v for k, v in self.events.items()},
                       **self.meta}, f)
        return path

    @staticmethod
    def load(directory: str) -> "HistoryLog":
        path = os.path.join(directory, "gameplay_history.npz")
        data = np.load(path)
        log = HistoryLog()
        comps = {}
        for k in data.files:
            if k.startswith("comp_") and k != "comp_mask":
                comps[k[len("comp_"):]] = data[k]
        log.baseline_world = {
            "alive": data["alive"],
            "comp_mask": data["comp_mask"],
            "comps": comps,
        }
        log.baseline_camera = data["camera"]
        log.frames_inputs = list(data["inputs"])
        log.frames_dt = list(data["dt"])
        # v1 recordings carry no flags: every frame advanced through the
        # standalone step program
        if "fused" in data.files:
            log.frames_fused = [bool(x) for x in data["fused"]]
        else:
            log.frames_fused = [False] * len(log.frames_dt)
        meta_path = os.path.join(directory, "history_meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                log.meta = json.load(f)
            log.events = {int(k): v
                          for k, v in log.meta.pop("events", {}).items()}
        return log

    # -- reconstruction ------------------------------------------------------
    def restore_world(self, config: W.WorldConfig) -> W.World:
        return W.restore(config, self.baseline_world)

    def restore_camera(self, template):
        return template.apply_serialized(jnp.asarray(self.baseline_camera))

    def frame(self, i: int) -> tuple[InputState, float]:
        return (
            InputState.deserialize(self.frames_inputs[i]),
            float(self.frames_dt[i]),
        )

    def advance_fused(self, i: int) -> bool:
        """Which program advanced recorded frame ``i`` (see record_frame);
        replay mirrors it exactly."""
        if i < len(self.frames_fused):
            return bool(self.frames_fused[i])
        return False
