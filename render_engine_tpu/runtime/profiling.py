"""Per-stage frame profiling.

The reference's only real profiling mechanism is TimeTakeHistory
(src/helper_things/cpu_usage_reducer.rs:30-131) — an EWMA of per-stage times
(alpha = 0.6 over 5 frames) used to choose serial-vs-rayon splits — plus ad
hoc frame wall-time prints (pipeline.rs:214,273). Under XLA the scheduler
role is moot (XLA owns scheduling), so this keeps the measurement half:

  * ``StageTimer``: EWMA per-stage host timings with the reference's decay
    constants — the frame-time HUD.
  * ``trace()``: a jax.profiler wrapper for deep dives (writes a TensorBoard
    trace directory).

JAX dispatches asynchronously, so a stage's time covers its device work
only when the stage waits for it: ``sync=`` takes a pytree that is
``block_until_ready``-fenced before the clock stops.
"""

from __future__ import annotations

import contextlib
import time

import jax

EWMA_ALPHA = 0.6  # same constant as TimeTakeHistory
EWMA_WINDOW = 5


class StageTimer:
    def __init__(self):
        self._ewma: dict[str, float] = {}
        self._history: dict[str, list] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            jax.block_until_ready(sync)
        dt = time.perf_counter() - t0
        hist = self._history.setdefault(name, [])
        hist.append(dt)
        del hist[:-EWMA_WINDOW]
        prev = self._ewma.get(name, dt)
        self._ewma[name] = EWMA_ALPHA * dt + (1.0 - EWMA_ALPHA) * prev

    def report(self) -> dict[str, float]:
        """EWMA milliseconds per stage."""
        return {k: v * 1e3 for k, v in self._ewma.items()}

    def hud_line(self) -> str:
        parts = [f"{k}={v:.1f}ms" for k, v in sorted(self.report().items())]
        return " | ".join(parts)


@contextlib.contextmanager
def trace(log_dir: str = "debug_out/trace"):
    """jax.profiler trace around a block (view in TensorBoard/XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
