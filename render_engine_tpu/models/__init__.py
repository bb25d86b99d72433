"""Model bank: geometry loading and packed device arrays.

Array-native redesign of the reference's model storage (src/models/): OBJ/MTL
loading (model_storage.rs:116-266), per-model AABBs, level-of-view variants
(model_definitions.rs:10-59), and instance bookkeeping. Instead of per-model
VBO uploads behind dirty flags, ALL models live concatenated in one set of
device arrays (vertices / normals / uvs / triangles / per-triangle material),
indexed by per-model (offset, count) tables — the renderer gathers, nothing
is ever re-uploaded.
"""

from render_engine_tpu.models.bank import ModelBank, ModelBankBuilder  # noqa: F401
from render_engine_tpu.models import primitives  # noqa: F401
from render_engine_tpu.models.obj_loader import load_obj  # noqa: F401
