"""Prelude: the canonical deferred setup most games want.

The reference's prelude (src/prelude/default_render_system.rs:30-231)
assembles the default deferred render system — model layouts, G-buffer
targets, uniform blocks, light budgets, 5 LoV bands, skybox — so user code
only supplies models and draw callbacks. The analogue here: one call that
builds the standard render-system set over a model bank, with the demo's
conventions (lit default system, unlit 6x-boost emissive system, transparency
routed by material alpha / entity flag).
"""

from render_engine_tpu.prelude.default_render_system import (  # noqa: F401
    default_render_systems,
)
from render_engine_tpu.render.render_system import (  # noqa: F401
    DrawParam,
    RenderSystemBuilder,
    ShadeParam,
)
