"""Supervision: crash-safe history flushing + heartbeat liveness.

Port of the reference's genuine supervision system (src/lib.rs:28-61,
159-283): per-thread heartbeat counters, sentinel failure values, a panic
hook that tags which thread died, and — crucially — the guarantee that a
crash still flushes the history including the fatal frame, making every
crash reproducible via playback (history_thread.rs:99-106).

Single-process analogue: a context manager around the frame loop that
(a) flushes the history log on ANY exit (graceful, exception, or signal),
(b) tracks a heartbeat the caller can poll from another thread, and
(c) optionally NaN-checks the world each frame (the fault-detection
analogue of jax_debug_nans) so state corruption is caught at the frame that
produced it and is replayable.
"""

from __future__ import annotations

import time
import traceback

import numpy as np


class Supervisor:
    def __init__(self, engine, nan_check_every: int = 0):
        self.engine = engine
        self.nan_check_every = nan_check_every
        self.heartbeat = 0  # monotonically increasing success counter
        self.failed = False
        self.failure_info: str | None = None
        self._t_last = time.monotonic()

    # -- context manager: flush-on-any-exit --------------------------------
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.failed = True
            self.failure_info = "".join(
                traceback.format_exception(exc_type, exc, tb)
            )
        path = self.engine.flush_history()
        if self.failed and path:
            # the crash frame's inputs are already in the log — replaying
            # reproduces the failure (the reference's elastic-recovery story)
            print(f"[supervisor] failure captured; history flushed to {path}")
        return False  # never swallow the exception

    # -- per-frame hooks ----------------------------------------------------
    def tick(self, inputs=None, dt: float = 1.0 / 60.0, render: bool = True):
        """Run one supervised frame."""
        img = self.engine.frame(inputs, dt, render=render)
        self.heartbeat += 1
        self._t_last = time.monotonic()
        if (
            self.nan_check_every
            and self.heartbeat % self.nan_check_every == 0
        ):
            self.check_state_health()
        return img

    def check_state_health(self):
        """Fault detection: NaN/Inf poisoning in any float component."""
        for name, arr in self.engine.world.comps.items():
            if arr.dtype.kind == "f":
                a = np.asarray(arr)
                if not np.isfinite(a[np.asarray(self.engine.world.alive)]).all():
                    self.failed = True
                    self.failure_info = f"non-finite values in {name!r}"
                    raise FloatingPointError(
                        f"[supervisor] NaN/Inf detected in component "
                        f"{name!r} at frame {self.engine.frame_index}"
                    )

    def seconds_since_heartbeat(self) -> float:
        """Liveness probe (the monitor thread's 1 Hz check, lib.rs:264-283)."""
        return time.monotonic() - self._t_last
