"""All-vs-all comparison as presence-matmul scoring, on one device or
a mesh.

Scoring model: let G be the number of distinct (minimizer, k-mer) pairs
observed across all N sketches and Pm the (G, N) 0/1 presence matrix.
Then S = Pm^T Pm has S[i,j] = |pairs shared by files i and j| (the
reference's score_A, Comparator.cpp:269-287) and S[i,i] =
nb_kmer_seen_infile[i]. This turns the comparison into batched matmuls:
pair-rows are tiled into chunks, chunks are sharded across the mesh
'data' axis, each device accumulates its partial S with an s8 x s8 ->
s32 matmul, and one cross-device sum merges the N x N partials.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from supersampler_tpu.compare.reader import decode_sketch_pairs


def build_presence_chunks(files: List[str], query_size: int = None):
    """Decode sketches and build group/file presence coordinates.

    Returns (group_ids int32[], file_ids int32[], n_groups, per-file
    pair counts, k, m). Groups = distinct (minimizer, kmer) pairs
    (query-mode bucket filtering applied to scoring groups only).
    """
    n = len(files)
    if query_size is None:
        query_size = n
    mins_l, his_l, los_l, fids_l = [], [], [], []
    nb_seen = [0] * n
    query_minimizers = set()
    k = m = 0
    for f, path in enumerate(files):
        mins, his, los, k, m, bucket_mins = decode_sketch_pairs(path)
        nb_seen[f] = int(mins.size)
        mins_l.append(mins)
        his_l.append(his)
        los_l.append(los)
        fids_l.append(np.full(mins.size, f, dtype=np.int32))
        if f < query_size:
            query_minimizers |= bucket_mins
    mins = np.concatenate(mins_l)
    his = np.concatenate(his_l)
    los = np.concatenate(los_l)
    fids = np.concatenate(fids_l)
    if query_size < n:
        qm = np.array(sorted(query_minimizers), dtype=np.uint64)
        keep = np.isin(mins, qm)
        mins, his, los, fids = mins[keep], his[keep], los[keep], fids[keep]
    order = np.lexsort((fids, los, his, mins))
    mins, his, los, fids = mins[order], his[order], los[order], fids[order]
    new_group = np.ones(mins.size, dtype=bool)
    if mins.size:
        new_group[1:] = ((mins[1:] != mins[:-1]) | (his[1:] != his[:-1])
                         | (los[1:] != los[:-1]))
    gids = (np.cumsum(new_group) - 1).astype(np.int32)
    n_groups = int(gids[-1]) + 1 if gids.size else 0
    return gids, fids.astype(np.int32), n_groups, nb_seen, k, m


@jax.jit
def _accumulate(total, block):       # (rows, N) int8
    return total + jnp.dot(block.T, block,
                           preferred_element_type=jnp.int32)


@functools.lru_cache(maxsize=8)
def _accumulate_sharded(mesh: Mesh, axis_name: str):
    """Per-device partial totals, sharded over the mesh; ONE
    cross-device reduction at the end instead of a psum per step.
    Cached per (mesh, axis) so the jit program persists across calls."""
    from jax import shard_map

    @jax.jit
    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)),
        out_specs=P(axis_name))
    def accumulate_sharded(totals, blocks):  # (n_dev, N, N)/(n_dev, R, N)
        return totals + jnp.dot(
            blocks[0].T, blocks[0],
            preferred_element_type=jnp.int32)[None]

    return accumulate_sharded


def score_matrix_device(gids: np.ndarray, fids: np.ndarray, n_groups: int,
                        n_files: int, mesh: Mesh = None,
                        chunk_groups: int = 1 << 18,
                        axis_name: str = "data") -> np.ndarray:
    """Accumulate S = Pm^T Pm over group-chunks on device.

    Presence blocks are built host-side ONE STEP AT A TIME — host
    memory is bounded by a single (n_dev * chunk_groups, N) int8 block
    regardless of the total group count (gids must be sorted, which
    the grouping construction guarantees) — and accumulated into the
    N x N score on device. int8 operands with int32 accumulation keep
    counts integer-exact. With a mesh, each step's rows are sharded
    over 'data' and the partial scores merged with one cross-device
    sum.

    Block row counts are bucketed to powers of two (zero rows score
    zero) so the jitted program's shapes recur across corpora; the jit
    wrappers live at module scope so they are traced and compiled once
    per shape, not once per call.
    """
    if n_groups == 0 or fids.size == 0:
        return np.zeros((n_files, n_files), dtype=np.int64)
    n_dev = 1 if mesh is None else mesh.devices.size
    # per-device rows per step: everything in one step when it fits
    # the host-block byte budget (~128 MB), else bounded chunks;
    # bucket to a power of two for jit shape reuse
    chunk_groups = min(chunk_groups, -(-n_groups // n_dev),
                       max(4096, (128 << 20) // (n_files * n_dev)))
    chunk_groups = 1 << max(12, (chunk_groups - 1).bit_length())
    rows_per_step = chunk_groups * n_dev
    n_steps = -(-n_groups // rows_per_step)

    if mesh is not None and n_dev > 1:
        accumulate_sharded = _accumulate_sharded(mesh, axis_name)
        shard_in = NamedSharding(mesh, P(axis_name))
        totals = jax.device_put(
            np.zeros((n_dev, n_files, n_files), np.int32), shard_in)

    # gids are sorted (cumsum construction): one searchsorted gives
    # every step's slice
    edges = np.searchsorted(
        gids, np.arange(1, n_steps + 1) * rows_per_step)
    total = jnp.zeros((n_files, n_files), jnp.int32)
    s = 0
    for step in range(n_steps):
        e = int(edges[step])
        block = np.zeros((rows_per_step, n_files), dtype=np.int8)
        block[gids[s:e] - step * rows_per_step, fids[s:e]] = 1
        if mesh is not None and n_dev > 1:
            # put with the target sharding: a plain asarray would
            # replicate the whole block to every device first
            totals = accumulate_sharded(
                totals, jax.device_put(
                    block.reshape(n_dev, chunk_groups, n_files),
                    shard_in))
        else:
            total = _accumulate(total, jnp.asarray(block))
        s = e
    if mesh is not None and n_dev > 1:
        total = jnp.sum(totals, axis=0)      # one all-reduce
    return np.asarray(total).astype(np.int64)


def scores_to_dict(score: np.ndarray, query_size: int) -> Dict[int, int]:
    """Upper-triangular score matrix -> the reference's score_A map
    (vectorized; the N^2 Python loop dominated at large file counts)."""
    n = score.shape[0]
    iu, ju = np.triu_indices(n, k=1)
    vals = score[iu, ju]
    nz = vals > 0
    keys = iu[nz].astype(np.int64) * n + ju[nz]
    return dict(zip(keys.tolist(), vals[nz].tolist()))
