"""comparator CLI — flag-compatible with the reference binary
(reference Comparator.cpp:464-521): -f index fof, -q query fof,
-p precision, -m min threshold, -o output prefix.
"""

from __future__ import annotations

import os
import sys
import time

from supersampler_tpu.compare.merge import TpuComparator

USAGE = """Core arguments:
-f Index file of files (mandatory)
-q Query file of files ("" for all versus all comparison of the index)
Ouput arguments:
-m Minimum value to be output (0.0)
-p Required precision to be output in the CSV (6)
-o output prefix (results)
"""


def pick_engine() -> str:
    """Scoring backend. SPSP_COMPARE_ENGINE=device|numpy overrides;
    otherwise the device (presence-matmul) engine, on whichever
    platform JAX reports (backend.engine() raises on any other)."""
    e = os.environ.get("SPSP_COMPARE_ENGINE", "auto")
    if e != "auto":
        return e
    from supersampler_tpu.backend import engine

    engine()
    return "device"


def parse_args(argv):
    opts = {"f": "", "q": "", "p": 6, "m": 0.0, "o": "results",
            "chunk_bytes": None, "resume": None}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("-") and len(a) == 2 and a[1] in "fqpmo":
            opts[a[1]] = argv[i + 1]
            i += 2
        elif a == "--chunk-bytes":      # framework extension: bounded-
            opts["chunk_bytes"] = int(argv[i + 1])   # memory streaming
            i += 2
        elif a == "--resume":           # framework extension: shard-
            opts["resume"] = argv[i + 1]             # resumable manifest
            i += 2
        else:
            i += 1
    opts["p"] = int(opts["p"])
    opts["m"] = float(opts["m"])
    return opts


def main(argv=None) -> int:
    o = parse_args(sys.argv[1:] if argv is None else argv)
    if not o["f"]:
        print(USAGE, end="")
        return 0
    from supersampler_tpu import enable_compilation_cache
    enable_compilation_cache()
    engine = pick_engine()

    def run_compare(comp, query_size):
        """Dispatch to the in-RAM or the chunked/resumable engine
        (--chunk-bytes / --resume are framework extensions beyond the
        reference flag set; outputs are identical either way)."""
        if o["chunk_bytes"] is not None or o["resume"] is not None:
            comp.compare_sketches_chunked(
                query_size,
                chunk_bytes=o["chunk_bytes"] or (64 << 20),
                resume_path=o["resume"])
        else:
            comp.compare_sketches(query_size)

    if not o["q"]:
        print("No query file, I will perform a all versus all comparison")
        comp = TpuComparator(precision=o["p"], min_threshold=o["m"],
                             engine=engine)
        comp.files_names = TpuComparator.getfilesname(o["f"])
        print(f"I found {len(comp.files_names)} documents")
        start = time.time()
        run_compare(comp, len(comp.files_names))
        print(f"kmers evaluated are of length: {comp.k} "
              f"minimizer size is {comp.m}")
        print("Comparisons done")
        mid = time.time()
        print(f"Comparisons lasted {mid - start} sec")
        print("Containement index dump ")
        print("Jackard index dump")
        comp.write_outputs(o["o"])
        print(f"Jaccard output lasted {time.time() - mid} sec")
    else:
        comp = TpuComparator(precision=o["p"], min_threshold=o["m"],
                             engine=engine)
        comp.files_names = TpuComparator.getfilesname(o["q"])
        query_size = len(comp.files_names)
        print(f"I query {query_size} file(s) against the bank")
        comp.files_names += TpuComparator.getfilesname(o["f"])
        run_compare(comp, query_size)
        print("Containement index dump ")
        print("Jackard index dump")
        comp.write_outputs(o["o"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
