"""Native (C++) components of the runtime.

The reference's runtime is native end to end (Rust); here the device compute
path is jax/XLA/Pallas and the host-side hot paths that benefit from
native code live in this package, each with a pure-Python fallback:

  * obj_loader.cpp — the model data-loader's parse core (tobj parity,
    model_storage.rs:116-266), built lazily with g++ and loaded via
    ctypes (build.py).

Set RE_NATIVE=0 to force the Python fallbacks.
"""
