"""The one backend dispatch point: which engines this platform runs.

Every choice between a GPU kernel and a plain XLA path asks `engine()`:

- ``"gpu"``: the Pallas-Triton field sweep (ops/field.py), the
  pointer-doubling chain walk (ops/walker.py), the fused single-tile
  scan+resolve program, and the device comparator engine;
- ``"cpu"``: the XLA reference paths (the field sweep as a `lax.scan`,
  the `while_loop` chain walk, split scan/resolve dispatches, which
  keep CPU compile times short).

Any other JAX platform raises: nothing in this package was written or
checked for it.
"""

from __future__ import annotations


def engine() -> str:
    """'gpu' or 'cpu' for the backend JAX reports; raises otherwise."""
    import jax

    plat = jax.default_backend()
    if plat in ("gpu", "cpu"):
        return plat
    raise RuntimeError(
        f"unsupported JAX platform {plat!r}: supersampler runs on an "
        "NVIDIA GPU (cuda) or on the CPU")
