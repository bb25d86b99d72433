"""Deferred rendering stack: geometry -> tile raster -> G-buffer -> lighting.

Array-native redesign of the reference's GL 4.5 deferred pipeline
(src/render_system/, src/render_components/, render_engine_assets/shaders/):
the GL rasterizer becomes a tile-based software rasterizer (pure-jnp
reference implementation + Pallas perf kernel), the G-buffer FBO becomes
(H, W, C) arrays, the stencil-tagged second pass becomes a fused lighting
kernel branching on a material-id channel, and mapped buffers / fences /
texture arrays dissolve into XLA-managed device arrays.
"""

from render_engine_tpu.render.geometry import TriangleBatch, build_triangle_batch  # noqa: F401
from render_engine_tpu.render.gbuffer import GBuffer  # noqa: F401
