"""Device-mesh sharding for the sketch pipeline.

The reference's only parallelism is an OpenMP file fan-out
(reference SubSampler.cpp:771-798). This design shards a
BATCH of padded sequence tiles across the mesh 'data' axis: each device
runs the full vectorized scan on its shard; no cross-device traffic is
needed for sketching (embarrassingly parallel, matching the reference's
file-level decomposition), so scaling is limited only by host IO.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from supersampler_tpu.ops import u64 as U
from supersampler_tpu.ops.minimizer import ScanTables, scan_tables


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = "data") -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), (axis_name,))


def batched_scan_fn(k: int, m: int, padded_len: int):
    """vmapped scan over a batch of sequences: (B, P) uint8 codes +
    (B,) lengths -> ScanTables with a leading batch axis."""

    def one(codes, length, t_hi, t_lo):
        return scan_tables(codes, k, m, padded_len, length,
                           U.U64(t_hi, t_lo))

    return jax.vmap(one, in_axes=(0, 0, None, None))


def sharded_scan_fn(mesh: Mesh, k: int, m: int, padded_len: int,
                    axis_name: str = "data"):
    """jit'd batched scan with batch sharded across the mesh.

    Batch size must be a multiple of the mesh size; each device holds
    and scans B/n sequences.
    """
    fn = batched_scan_fn(k, m, padded_len)
    data = NamedSharding(mesh, P(axis_name))
    repl = NamedSharding(mesh, P())
    return jax.jit(fn,
                   in_shardings=(data, data, repl, repl),
                   out_shardings=data)


def sharded_field_resolve_fn(mesh: Mesh, k: int, m: int, P_rec: int,
                             sel_cap: int, axis_name: str = "data"):
    """Mesh-sharded PRODUCT sketch engine: the fused batched field
    scan+resolve (ops/field.py scan_resolve_batch — the same program
    TpuSubsampler.sketch_file dispatches) with the record batch
    sharded across the mesh axis.

    Sketching is embarrassingly parallel over records (the reference's
    only parallelism is the file-level OpenMP fan-out,
    SubSampler.cpp:771-798), so each device resolves its shard with no
    collectives; the returned (n_dev, arr_len) array stacks each
    device's fetch array — parse each row's records with
    parse_batched_array(row, sel_cap, B // n_dev).

    packed: (B, P_rec//4) uint8, lengths: (B,) i32; B must be a
    multiple of the mesh size."""
    from jax import shard_map

    from supersampler_tpu.ops.field import scan_resolve_batch

    def local(packed, lengths, thi, tlo):
        return scan_resolve_batch(packed, k, m, P_rec, sel_cap,
                                  lengths, thi, tlo)[None, :]

    # check_vma off: the local program is collective-free (purely
    # per-record), but its lax.scan carries start from unvarying
    # constants, which the varying-manual-axes checker rejects.
    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(axis_name), P(axis_name), P(), P()),
                   out_specs=P(axis_name), check_vma=False)
    return jax.jit(fn)
