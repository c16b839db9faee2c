"""supersampler_tpu — Fractional Hitting Set k-mer sketching on the GPU.

A from-scratch JAX/XLA/Pallas reimplementation of the capabilities of
TimRouze/supersampler with bit-identical outputs.
"""

import os

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(_ROOT, "build", "jax_cache")


def enable_compilation_cache() -> None:
    """Enable JAX's persistent compilation cache so fresh CLI processes
    skip the per-shape XLA compile. Where JAX_COMPILATION_CACHE_DIR is
    set, JAX already uses it and nothing is set here; otherwise the
    cache lives at a fixed path inside the checkout (build/jax_cache),
    so every process of this checkout finds it again. Safe to call
    more than once."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
