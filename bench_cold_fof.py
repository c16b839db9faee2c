"""Cold-process fof benchmark worker (invoked by bench.py before it
opens the device, so only this process holds the card).

Measures what a real CLI invocation sees: a fresh process sketching the
fof corpus through the shared pipeline, compilation or compile-cache
loading included, then the same corpus a second time in that process.
Prints one JSON line:

  {"cold_total_s": ..., "cold_phases": {...},
   "warm_repeat_s": ..., "warm_phases": {...}, "mbases": ...}

The phase breakdown separates compilation, which lands inside
`dispatch`/`device+fetch` of the cold run.
"""

import json
import sys
import time


def main() -> int:
    fof_path = sys.argv[1]
    k, m, s = int(sys.argv[2]), int(sys.argv[3]), float(sys.argv[4])

    sys.path.insert(0, ".")
    from supersampler_tpu import enable_compilation_cache
    enable_compilation_cache()
    from supersampler_tpu.io.fasta import read_fof
    from supersampler_tpu.sketch.pipeline import TpuSubsampler, sketch_fof
    from supersampler_tpu.utils.profiling import timers

    entries = read_fof(fof_path, min_len=3)

    def run():
        timers.reset()
        items = [(TpuSubsampler(k=k, m=m, s=s), p) for p in entries]
        t0 = time.perf_counter()
        sketch_fof(items)
        dt = time.perf_counter() - t0
        return dt, {n: round(v, 4) for n, v in timers.totals.items()}

    cold_s, cold_ph = run()
    warm_s, warm_ph = run()
    total = 0
    for p in entries:
        from supersampler_tpu.io.fasta import iter_fasta_records
        for rec in iter_fasta_records(p):
            total += len(rec)
    print(json.dumps({
        "cold_total_s": round(cold_s, 4), "cold_phases": cold_ph,
        "warm_repeat_s": round(warm_s, 4), "warm_phases": warm_ph,
        "mbases": round(total / 1e6, 3)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
