"""All-vs-all / N-vs-all sketch comparison over decoded pair sets.

Semantic model (provably equivalent to the reference's streaming N-way
merge, Comparator.cpp:39-74 + 97-287):

* nb_kmer_seen_infile[f] = |distinct (minimizer, canonical k-mer) pairs
  of file f| — the per-bucket skip/color maps dedup within a bucket and
  buckets are unique per file (std::map keys), so summing per-bucket
  distinct counts equals the global pair-set size.
* score_A[i,j] = number of distinct pairs present in both i and j,
  restricted (query mode) to buckets whose minimizer is held by at
  least one query file (Comparator.cpp:340-351: only `queryfound`
  buckets run count_intersection; within such buckets ALL co-occurring
  file pairs are scored, compute_scores Comparator.cpp:269-287).

The sorted-array implementation groups identical pairs across files and
accumulates pairwise counts; a device matmul path (P^T P over presence
blocks) lives in parallel/compare_dist.py, on one device or a mesh.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np

from supersampler_tpu.compare.reader import decode_sketch_pairs
from supersampler_tpu.compare.writers import matrix_csv, write_matrix_gz

U64 = np.uint64


class TpuComparator:
    """Drop-in equivalent of the reference Comparator
    (same outputs as oracle.OracleComparator).

    engine selects the pairwise-scoring backend once the decoded pairs
    are grouped: "numpy" enumerates co-occurrence pairs on host;
    "device" runs the presence-matmul S = P^T P on the device
    (parallel/compare_dist.py), optionally sharded over a mesh with
    one cross-device sum. Both produce identical score_A.
    """

    def __init__(self, precision: int = 6, min_threshold: float = 0.0,
                 engine: str = "numpy", mesh=None):
        self.precision = precision
        self.min_threshold = min_threshold
        self.engine = engine
        self.mesh = mesh
        self.files_names: List[str] = []
        self.score_A: Dict[int, int] = {}
        self.nb_kmer_seen_infile: List[int] = []
        self.query_size = 0
        self.nb_files = 0
        self.k = 0
        self.m = 0

    @staticmethod
    def getfilesname(fof_path: str) -> List[str]:
        """fof lines with size > 2 (reference Comparator.cpp:7-21)."""
        from supersampler_tpu.oracle.comparator import OracleComparator

        return OracleComparator.getfilesname(fof_path)

    def compare_sketches(self, query_size: int) -> None:
        # Unopenable sketches print the reference's message and drop out
        # of the comparison; surviving files take compacted indices
        # (reference Comparator.cpp:45-51 + utils.cpp:357-364).
        opened: List[str] = []
        for path in self.files_names:
            try:
                with open(path, "rb"):
                    pass
            except OSError:
                print("Problem with file opening")
                continue
            opened.append(path)
        n = len(opened)
        self.query_size = query_size
        self.nb_files = n
        mins_l, his_l, los_l, fids_l = [], [], [], []
        query_minimizers: Set[int] = set()
        self.nb_kmer_seen_infile = [0] * n
        for f, path in enumerate(opened):
            mins, his, los, k, m, bucket_mins = decode_sketch_pairs(path)
            # like get_header_info, the last file's header wins
            self.k, self.m = k, m
            self.nb_kmer_seen_infile[f] = int(mins.size)
            mins_l.append(mins)
            his_l.append(his)
            los_l.append(los)
            fids_l.append(np.full(mins.size, f, dtype=np.int64))
            if f < query_size:
                query_minimizers |= bucket_mins
        mins = np.concatenate(mins_l) if mins_l else np.zeros(0, U64)
        his = np.concatenate(his_l) if his_l else np.zeros(0, U64)
        los = np.concatenate(los_l) if los_l else np.zeros(0, U64)
        fids = np.concatenate(fids_l) if fids_l else np.zeros(0, np.int64)
        self._score_pairs(mins, his, los, fids, query_size,
                          query_minimizers)

    def compare_sketches_chunked(self, query_size: int,
                                 chunk_bytes: int = 64 << 20,
                                 resume_path: Optional[str] = None,
                                 max_chunks: Optional[int] = None
                                 ) -> bool:
        """Bounded-memory comparison: stream the N-way bucket merge in
        minimizer-range chunks of ~chunk_bytes payload, scoring each
        chunk as it decodes (reference Comparator.cpp:39-74 holds only
        open buckets; this holds only one chunk). Produces identical
        score_A / nb_kmer_seen_infile to compare_sketches — every
        minimizer's buckets land in exactly one chunk, so per-chunk
        grouping and dedup equal global.

        resume_path: shard-resumable comparison (SURVEY §5) — after
        every chunk the per-file byte offsets + partial scores persist
        atomically; a restart skips completed chunks by seeking. The
        manifest is deleted on completion. max_chunks stops early
        (testing / cooperative preemption), leaving the manifest.

        Returns True when the comparison completed."""
        import json
        import os

        from supersampler_tpu.compare.stream import (BucketStream,
                                                     chunk_rounds,
                                                     decode_bucket_pairs)

        opened: List[str] = []
        for path in self.files_names:
            try:
                with open(path, "rb"):
                    pass
            except OSError:
                print("Problem with file opening")
                continue
            opened.append(path)
        n = len(opened)
        self.query_size = query_size
        self.nb_files = n
        if n == 0:
            return True
        streams = [BucketStream(p) for p in opened]
        self.k, self.m = streams[-1].k, streams[-1].m
        self.nb_kmer_seen_infile = [0] * n
        start_chunk = 0
        if resume_path and os.path.exists(resume_path):
            with open(resume_path) as f:
                man = json.load(f)
            if man.get("files") != opened:
                raise ValueError(
                    "resume manifest does not match the file list")
            start_chunk = man["chunk_idx"]
            for st, off in zip(streams, man["offsets"]):
                st.offset = off
            self.score_A = {int(key): v
                            for key, v in man["score_A"].items()}
            self.nb_kmer_seen_infile = list(man["nb_seen"])
        self.max_chunk_pairs = 0
        done = True
        for idx, chunk, offsets in chunk_rounds(streams, chunk_bytes):
            mins_l, his_l, los_l, fids_l = [], [], [], []
            qmins: Set[int] = set()
            for f, buckets in enumerate(chunk):
                if f < query_size:
                    qmins.update(b[0] for b in buckets)
                if not buckets:
                    continue
                mins, his, los = decode_bucket_pairs(buckets,
                                                     self.k, self.m)
                self.nb_kmer_seen_infile[f] += int(mins.size)
                mins_l.append(mins)
                his_l.append(his)
                los_l.append(los)
                fids_l.append(np.full(mins.size, f, dtype=np.int64))
            if mins_l:
                mins = np.concatenate(mins_l)
                his = np.concatenate(his_l)
                los = np.concatenate(los_l)
                fids = np.concatenate(fids_l)
                self.max_chunk_pairs = max(self.max_chunk_pairs,
                                           int(mins.size))
                self._score_pairs(mins, his, los, fids, query_size,
                                  qmins if query_size < n else None)
            if resume_path:
                tmp = resume_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump({
                        "files": opened,
                        "chunk_idx": start_chunk + idx + 1,
                        "offsets": offsets,
                        "score_A": {str(key): v for key, v
                                    in self.score_A.items()},
                        "nb_seen": self.nb_kmer_seen_infile,
                    }, f)
                os.replace(tmp, resume_path)
            if max_chunks is not None and idx + 1 >= max_chunks:
                done = all(st.exhausted() for st in streams)
                break
        if done and resume_path and os.path.exists(resume_path):
            os.remove(resume_path)
        return done

    def _score_pairs(self, mins, his, los, fids, query_size: int,
                     query_minimizers: Optional[Set[int]] = None) -> None:
        """Score decoded (minimizer, k-mer, file) pair arrays — the
        post-decode half of compare_sketches, also the entry point for
        the multi-host path (parallel/dist.py), which gathers pair
        arrays across hosts before scoring."""
        n = self.nb_files
        if mins.size == 0:
            return

        # Query-mode bucket filter.
        if query_size < n and query_minimizers is not None:
            qm = np.array(sorted(query_minimizers), dtype=U64)
            keep = np.isin(mins, qm)
            mins, his, los, fids = mins[keep], his[keep], los[keep], fids[keep]
            if mins.size == 0:
                return

        order = np.lexsort((fids, los, his, mins))
        mins, his, los, fids = mins[order], his[order], los[order], fids[order]
        new_group = np.ones(mins.size, dtype=bool)
        new_group[1:] = ((mins[1:] != mins[:-1]) | (his[1:] != his[:-1])
                         | (los[1:] != los[:-1]))
        gid = np.cumsum(new_group) - 1

        if self.engine == "device":
            from supersampler_tpu.parallel.compare_dist import (
                score_matrix_device, scores_to_dict)

            n_groups = int(gid[-1]) + 1
            score = score_matrix_device(
                gid.astype(np.int32), fids.astype(np.int32), n_groups, n,
                mesh=self.mesh)
            for key, v in scores_to_dict(score, query_size).items():
                self.score_A[key] = self.score_A.get(key, 0) + v
            return

        counts = np.bincount(gid)
        # only groups with >= 2 files contribute scores
        big = counts >= 2
        if not big.any():
            return
        sel = big[gid]
        gid_sel = gid[sel]  # non-decreasing (sort order preserved)
        fid_sel = fids[sel]  # ascending within each group (lexsort key)
        _, gstart, gcount = np.unique(gid_sel, return_index=True,
                                      return_counts=True)
        # vectorized pairwise accumulation: within a group every file id
        # is distinct and sorted, so enumerate ordered pairs by local
        # distance d (bounded by nb_files) instead of a per-group loop
        nbf = n
        starts = np.repeat(gstart, gcount)
        counts_per_elem = np.repeat(gcount, gcount)
        local = np.arange(fid_sel.size) - starts
        keys_all = []
        max_c = int(gcount.max())
        for d in range(1, max_c):
            a = np.nonzero(local + d < counts_per_elem)[0]
            if a.size == 0:
                break
            keys_all.append(fid_sel[a] * nbf + fid_sel[a + d])
        if keys_all:
            keys = np.concatenate(keys_all)
            uniq, cnt = np.unique(keys, return_counts=True)
            pair_keys: Dict[int, int] = self.score_A
            for key, c in zip(uniq.tolist(), cnt.tolist()):
                pair_keys[key] = pair_keys.get(key, 0) + c

    # ------------------------------------------------------------------
    def _header_names(self) -> List[str]:
        """The reference prints files_names[0..nb_files) even when a
        failed open compacted the data indices (Comparator.cpp:365-372
        never re-syncs names) — replicated verbatim."""
        n = self.nb_files or len(self.files_names)
        return self.files_names[:n]

    def containment_csv(self) -> str:
        return matrix_csv(self._header_names(), self.score_A,
                          self.nb_kmer_seen_infile, self.query_size,
                          self.precision, self.min_threshold, jaccard=False)

    def jaccard_csv(self) -> str:
        return matrix_csv(self._header_names(), self.score_A,
                          self.nb_kmer_seen_infile, self.query_size,
                          self.precision, self.min_threshold, jaccard=True)

    def write_outputs(self, output_name: str = "results") -> None:
        write_matrix_gz(f"{output_name}_containment.csv.gz",
                        self.containment_csv())
        write_matrix_gz(f"{output_name}_jaccard.csv.gz", self.jaccard_csv())
