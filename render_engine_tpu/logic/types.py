"""Entity types, logic callbacks, and the per-frame input snapshot.

The reference wires per-type behaviour through function-pointer maps keyed by
TypeId (``InstanceLogic``: entity / random_entity / collision /
random_collision / out_of_bounds, reference src/exports/load_models.rs:73-95,
callback signatures src/exports/logic_components.rs:15-50). A jit-friendly
design needs a *closed* set of callbacks at trace time (SURVEY.md section 7
hard part 3): entity types are declared up front as ``EntityType`` records;
the step unrolls over them, each callback running vectorized over the whole
entity arrays under a ``(alive & type & active)`` mask.

Callback signatures (all pure; ``cs`` is the frame's accumulating ChangeSet):

  logic(world, dt, mask, cs) -> cs
      the EntityLogic analogue: vectorized over all entities, write updates
      masked by ``mask`` (bool[CAP]).
  random_logic(world, dt, mask, rng, cs) -> cs
      the reference's random_entity_logic: nondeterminism is *allowed* here
      because the rng key is part of the recorded frame inputs — replay
      feeds the same key, so recompute is bit-identical (the reference
      instead records these changes, load_models.rs:76).
  collision(world, other_idx, mask, cs) -> cs
      CollisionLogic analogue: ``other_idx`` int32[CAP] is, per entity of
      this type, the first colliding entity's index; ``mask`` marks entities
      that actually collided this frame. The other entity is read-only —
      the EntityIdRead contract (entity_id.rs:6-51) by construction.
      A callback may additionally accept ``other_type=None`` (int32[CAP],
      the contact's type id, -1 where unmasked): the engine passes it
      pre-compacted from the collision candidate rows, so type filters
      need no ``world["type_id"][other_idx]`` gather (a full-capacity 1-D
      int gather per callback).
      ``random_collision`` callbacks may accept the same kwarg.
  user_input(world, camera, inputs, dt, cs) -> (cs, camera)
      UserInputLogic analogue, runs once for the user entity's type.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

# Out-of-bounds policies (reference OutOfBoundsLogic + IsOutOfBounds marker /
# delete path, entity_change_helpers.rs:325-351)
OOB_CLAMP = "clamp"
OOB_DELETE = "delete"
OOB_MARK = "mark"


@dataclasses.dataclass(frozen=True)
class EntityType:
    """One registered entity type (the TypeIdentifier analogue, ecs.rs:91-110
    — but an explicit small integer instead of a transmuted TypeId)."""

    name: str
    index: int
    logic: Optional[Callable] = None
    random_logic: Optional[Callable] = None
    collision: Optional[Callable] = None
    # collision callback with access to the frame rng (the reference's
    # random_collision_logic map, load_models.rs:76-95); its changes replay
    # exactly because the rng derives from the recorded frame seed.
    # Signature: (world, other_idx, mask, rng, cs) -> cs
    random_collision: Optional[Callable] = None
    user_input: Optional[Callable] = None
    out_of_bounds: str = OOB_CLAMP
    # user out-of-bounds callback (the reference's OutOfBoundsLogic fn
    # registered per type, logic_components.rs:15-18, invoked from
    # entity_change_helpers.rs:325-351 after the marker/delete pass).
    # Signature: (world, mask, cs) -> cs, where ``mask`` is bool[CAP] over
    # this type's entities that left the world bounds this frame — runs
    # AFTER the policy (so OOB_MARK + callback mirrors the reference's
    # mark-then-custom-handling flow; the callback may despawn, teleport,
    # or otherwise amend the frame's ChangeSet).
    out_of_bounds_logic: Optional[Callable] = None

    def __hash__(self):
        return hash((self.name, self.index, self.out_of_bounds,
                     id(self.logic), id(self.random_logic),
                     id(self.collision), id(self.random_collision),
                     id(self.user_input), id(self.out_of_bounds_logic)))


# Key indices for InputState.keys — the MovementKeys analogue
# (src/window/movement_keys.rs:4-41) plus the playback-control keys
# (render_thread.rs:323-400).
KEY_W, KEY_A, KEY_S, KEY_D = 0, 1, 2, 3
KEY_SPACE, KEY_SHIFT = 4, 5
KEY_UP, KEY_DOWN, KEY_LEFT, KEY_RIGHT = 6, 7, 8, 9
KEY_ESC, KEY_INSERT = 10, 11
NUM_KEYS = 16
# packed dispatch vector: keys | prev_keys | mouse(2) | seed lo/hi | dt
PACKED_INPUT_LEN = 2 * NUM_KEYS + 5


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["keys", "mouse_delta", "rng_seed", "prev_keys"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class InputState:
    """One frame's input snapshot — the CurrentFrameInput analogue
    (src/window/input_state.rs:5-158). This (plus dt) is the entire replay
    wire format: record the stream, replay it, get identical bits.

    ``prev_keys`` carries the previous frame's key state (the InputHistory
    role): it is DERIVED by the engine from the stream, not recorded —
    replay reconstructs it identically."""

    keys: jnp.ndarray  # bool[NUM_KEYS]
    mouse_delta: jnp.ndarray  # (2,) f32, yaw/pitch deltas in radians
    rng_seed: jnp.ndarray  # uint32 scalar: per-frame randomness source
    prev_keys: jnp.ndarray = None  # bool[NUM_KEYS], engine-maintained

    # NOTE: host-side constructors use NUMPY deliberately — every eager jnp
    # op is a device dispatch, and a handful of those per frame can cost
    # more than the whole world tick.

    def __post_init__(self):
        if self.prev_keys is None:
            import numpy as _np

            object.__setattr__(self, "prev_keys",
                               _np.zeros(NUM_KEYS, bool))

    @staticmethod
    def idle(seed: int = 0) -> "InputState":
        import numpy as _np

        return InputState(
            keys=_np.zeros(NUM_KEYS, bool),
            mouse_delta=_np.zeros(2, _np.float32),
            rng_seed=_np.uint32(seed),
        )

    def with_keys(self, *indices: int) -> "InputState":
        import numpy as _np

        keys = _np.array(self.keys)
        for i in indices:
            keys[i] = True
        return dataclasses.replace(self, keys=keys)

    # -- InputHistory queries (input_state.rs pressed/held/released) -----
    def pressed(self, i: int) -> jnp.ndarray:
        """Key went down this frame."""
        return self.keys[i] & ~self.prev_keys[i]

    def released(self, i: int) -> jnp.ndarray:
        return ~self.keys[i] & self.prev_keys[i]

    def held(self, i: int) -> jnp.ndarray:
        """Down both this and last frame."""
        return self.keys[i] & self.prev_keys[i]

    def with_prev(self, prev_keys) -> "InputState":
        return dataclasses.replace(self, prev_keys=prev_keys)

    def serialize(self):
        """Flatten to one f32 vector for the history log (host-side numpy —
        recording must not cost device dispatches)."""
        import numpy as _np

        # rng_seed travels as a bit-exact uint32 view (seeds above 2^24
        # would lose bits in a float round-trip -> silent replay divergence)
        return _np.concatenate([
            _np.asarray(self.keys, _np.float32),
            _np.asarray(self.mouse_delta, _np.float32),
            _np.asarray([self.rng_seed], _np.uint32).view(_np.float32),
        ])

    @staticmethod
    def deserialize(v) -> "InputState":
        import numpy as _np

        v = _np.asarray(v, _np.float32)
        return InputState(
            keys=v[:NUM_KEYS] > 0.5,
            mouse_delta=v[NUM_KEYS:NUM_KEYS + 2],
            rng_seed=v[NUM_KEYS + 2:NUM_KEYS + 3].view(_np.uint32)[0],
        )

    # -- one-transfer dispatch wire ---------------------------------------
    # Every small host array passed to a jitted program is its own
    # host->device transfer with its own dispatch latency. The engine
    # therefore ships (keys,
    # prev_keys, mouse, seed, dt) as ONE f32 vector and unpacks inside the
    # compiled program. Bit-exact by construction: keys are 0/1, mouse/dt
    # are f32 pass-through, and the uint32 seed travels as two 16-bit
    # halves (< 2^24, exact in f32 — a raw bit VIEW could land on a NaN
    # payload, which transfers may canonicalize).
    def pack_with_dt(self, dt) -> "np.ndarray":
        import numpy as _np

        seed = int(_np.uint32(self.rng_seed))
        out = _np.empty(PACKED_INPUT_LEN, _np.float32)
        k = NUM_KEYS
        out[0:k] = _np.asarray(self.keys, _np.float32)
        out[k:2 * k] = _np.asarray(self.prev_keys, _np.float32)
        out[2 * k:2 * k + 2] = _np.asarray(self.mouse_delta, _np.float32)
        out[2 * k + 2] = seed & 0xFFFF
        out[2 * k + 3] = seed >> 16
        out[2 * k + 4] = _np.float32(dt)
        return out

    @staticmethod
    def unpack_with_dt(vec) -> tuple["InputState", jnp.ndarray]:
        """Traced inverse of ``pack_with_dt`` (runs inside jit)."""
        k = NUM_KEYS
        seed = (vec[2 * k + 3].astype(jnp.uint32) << 16) | vec[
            2 * k + 2].astype(jnp.uint32)
        return InputState(
            keys=vec[0:k] > 0.5,
            mouse_delta=vec[2 * k:2 * k + 2],
            rng_seed=seed,
            prev_keys=vec[k:2 * k] > 0.5,
        ), vec[2 * k + 4]
