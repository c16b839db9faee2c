"""Multi-host orchestration: jax.distributed init + host-level work
ownership for sketching and comparison.

The reference's only parallelism is an OpenMP fan-out over files
(reference SubSampler.cpp:771-798). The multi-host design keeps that
embarrassing parallelism at the host level — each process sketches the
fof entries it owns — and shards the all-vs-all comparison by GROUP
CHUNKS: every host decodes only its fof shard, builds presence chunks,
and the N x N score partials merge with one psum over the global mesh
(parallel/compare_dist.py). No host ever materializes another host's
sketches.

Single-process environments (tests, one-card machines) run the same
code with process_count == 1; `initialize()` is a no-op there.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> None:
    """jax.distributed.initialize, env-driven and idempotent.

    On a single process (no coordinator configured) this is a no-op, so
    every CLI works unchanged on one machine. For several processes,
    set JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    (or pass them) before the first jax call.

    Cards: by default one process drives every card of its host. To run
    one process per card instead, pass each process its own
    `local_device_ids` (e.g. [process_id % cards_per_host]); a JAX
    process reserves most of a card's memory when it first touches it,
    so two processes must never share one.
    """
    import jax

    coord = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if not coord:
        return
    nproc = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", 1))
    pid = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", 0))
    try:
        jax.distributed.initialize(coordinator_address=coord,
                                   num_processes=nproc, process_id=pid,
                                   local_device_ids=local_device_ids)
    except RuntimeError:
        pass  # already initialized


def process_info():
    """(process_index, process_count) — (0, 1) before/without init."""
    import jax

    try:
        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


def owned_shard(items: Sequence, index: Optional[int] = None,
                count: Optional[int] = None) -> List:
    """This host's strided shard of a work list (fof entries, sketch
    files): item i belongs to host i % count. Strided (not blocked) so
    genome-size skew spreads evenly."""
    if index is None or count is None:
        index, count = process_info()
    return [x for i, x in enumerate(items) if i % count == index]


def sketch_fof_distributed(entries: Sequence[str], make_subsampler,
                           prefix: str) -> List[str]:
    """Sketch this host's shard of a fof (each host writes only its own
    outputs); returns the LOCAL output paths. The global out-fof is the
    deterministic union (every host can reconstruct it: ownership is a
    pure function of the index)."""
    from supersampler_tpu.sketch import subsample_file

    out = []
    for path in owned_shard(list(entries)):
        ss = make_subsampler()
        out.append(subsample_file(ss, path, prefix))
    return out


def compare_all_vs_all_distributed(files: Sequence[str], mesh=None,
                                   query_size: Optional[int] = None,
                                   chunk_groups: int = 4096):
    """All-vs-all comparison with per-host DECODE ownership.

    A (minimizer, k-mer) pair held by files on two different hosts must
    land in the same group row of S = P^T P, so group identity needs
    global pair visibility: each host decodes only its strided shard of
    the sketch files (the expensive part — gunzip + unpack + windows),
    then the pair ARRAYS (the compressed representation, ~s-fold
    smaller than the genomes) are exchanged with one process
    all-gather, and scoring proceeds on mesh-sharded presence chunks
    with a psum merge (parallel/compare_dist.py). Single-process runs
    take the plain device-engine path.
    """
    import jax

    from supersampler_tpu.compare.merge import TpuComparator

    idx, cnt = process_info()
    comp = TpuComparator(engine="device", mesh=mesh)
    comp.files_names = list(files)
    if query_size is None:
        query_size = len(files)
    if cnt == 1:
        comp.compare_sketches(query_size)
        return comp
    # Multi-host: each host decodes its shard, then pair arrays are
    # exchanged host-to-host via jax process allgather (compressed
    # domain), after which scoring proceeds as single-host.
    from jax.experimental import multihost_utils

    from supersampler_tpu.compare.reader import decode_sketch_pairs

    shard = owned_shard(list(enumerate(files)), idx, cnt)
    parts = []
    for f, path in shard:
        mins, his, los, k, m, _ = decode_sketch_pairs(path)
        comp.k, comp.m = k, m
        parts.append(np.stack([
            mins, his, los,
            np.full(mins.size, f, np.uint64)]))
    local = (np.concatenate(parts, axis=1) if parts
             else np.zeros((4, 0), np.uint64))
    # process_allgather requires shape-equal locals; per-host pair
    # counts differ (strided fof shards), so exchange sizes first and
    # pad to the maximum before gathering, trimming after. The u64
    # pair values travel as u32 limb views: without jax_enable_x64 a
    # u64 device array silently truncates to 32 bits (collapsing
    # distinct k-mers into collisions).
    n_local = local.shape[1]
    sizes = np.asarray(multihost_utils.process_allgather(
        np.array([n_local], np.int32), tiled=False)).reshape(-1)
    mx = max(int(sizes.max()), 1)
    local32 = np.ascontiguousarray(local).view(np.uint32)   # (4, 2n)
    padded = np.zeros((4, 2 * mx), np.uint32)
    padded[:, : 2 * n_local] = local32
    gathered = np.asarray(multihost_utils.process_allgather(
        padded, tiled=False)).reshape(cnt, 4, 2 * mx)
    allp = np.concatenate(
        [np.ascontiguousarray(gathered[i][:, : 2 * int(sizes[i])])
         .view(np.uint64) for i in range(cnt)], axis=1)
    fids = allp[3].astype(np.int64)
    comp.nb_files = len(files)
    comp.query_size = query_size
    comp.nb_kmer_seen_infile = np.bincount(
        fids, minlength=len(files)).tolist()
    qmins = (set(np.unique(allp[0][fids < query_size]).tolist())
             if query_size < len(files) else None)
    comp._score_pairs(allp[0], allp[1], allp[2], fids, query_size, qmins)
    return comp
