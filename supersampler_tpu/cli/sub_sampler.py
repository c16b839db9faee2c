"""sub_sampler CLI — flag-compatible with the reference binary
(reference SubSampler.cpp:667-803): -i input, -f file-of-files,
-k kmer, -m minimizer, -t threads, -s rate, -p prefix, -v verbose,
-x type, -a abundance.
"""

from __future__ import annotations

import io
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from supersampler_tpu.core.scalar import format_g6
from supersampler_tpu.io.fasta import get_out_name, read_fof
from supersampler_tpu.sketch import print_stat, subsample_file
from supersampler_tpu.sketch.pipeline import TpuSubsampler

USAGE = """Core arguments:
	-i Input file
	-f Input file of file
	-p Output prefix (subsampled)
	-k Kmer size used  (31)
	-s Subsampling used  (1000)
	-t Threads used  (8)
	-m Minimizer size used  (11, max value is 15)
	-v Verbose level (1)
	-a Abundance min (2)
	-3/2/1 respectively Max skmers + any sized skmers + cursed skmers OR Max skmers and any sized skmers OR max skmers only. (default 3)
"""


def parse_args(argv):
    opts = {"i": "", "f": "", "k": 31, "m": 11, "t": 8, "s": "1000",
            "p": "subsampled_", "v": 1, "x": 3, "a": 1}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("-") and len(a) == 2 and a[1] in "ifkmtspvxa":
            opts[a[1]] = argv[i + 1]
            i += 2
        else:
            i += 1
    opts["k"] = int(opts["k"])
    opts["m"] = int(opts["m"])
    opts["t"] = int(opts["t"])
    opts["v"] = int(opts["v"])
    opts["x"] = int(opts["x"])
    opts["a"] = int(opts["a"])
    return opts


def main(argv=None) -> int:
    o = parse_args(sys.argv[1:] if argv is None else argv)
    if not o["i"] and not o["f"]:
        print(USAGE, end="")
        return 0
    from supersampler_tpu import enable_compilation_cache
    enable_compilation_cache()
    k, m = o["k"], o["m"]
    if m % 2 == 0:
        print("Minimizer size must be odd")
        m += 1
    if k % 2 == 0:
        print("Kmer size must be odd")
        k += 1
    if m > 15:
        print("Minimizer size can't be greater than 15.")
        m = 15
    # -s parsed with stof (float32) into a double (SubSampler.cpp:698)
    s = float(np.float32(o["s"]))
    print(f" I use k={k} m={m} s={format_g6(s)}")
    print(f"Maximal super kmer are of length {2 * k - m} or {k - m + 1} kmers")
    if o["i"]:
        ss = TpuSubsampler(k=k, m=m, s=s, abundance=o["a"])
        subsample_file(ss, o["i"], o["p"])
        if o["v"]:
            print_stat(ss, sys.stdout)
    else:
        # ONE shared device pipeline across all fof entries
        # (sketch_fof): record batches from different files share
        # grouped H2D transfers, fused dispatches and stacked D2H
        # fetches, amortizing per-transfer costs the way the
        # reference amortizes cores with its OpenMP fan-out
        # (SubSampler.cpp:771-798). -t is accepted for flag parity;
        # the shared pipeline sizes its own worker pools. Per-file
        # output is buffered and emitted in fof order so runs are
        # deterministic (a valid serialization of the reference's
        # critical-section interleaving); gzip writes overlap the
        # remaining device work on a small writer pool.
        entries = read_fof(o["f"], min_len=3)
        out_fof_name = get_out_name(o["f"], o["p"]) + ".txt"
        from supersampler_tpu.io.gzip_exact import write_gzip_exact
        from supersampler_tpu.sketch.pipeline import sketch_fof

        bufs = [io.StringIO() for _ in entries]
        sss = []
        for path, buf in zip(entries, bufs):
            print(path, file=buf)
            ss = TpuSubsampler(k=k, m=m, s=s, abundance=o["a"])
            ss.log = buf
            sss.append(ss)
        out_paths = [get_out_name(p, o["p"]) + ".gz" for p in entries]
        for ss, out_path in zip(sss, out_paths):
            ss.subsampled_file = out_path
        with ThreadPoolExecutor(2) as writers:
            wfuts = []

            def write_result(idx, raw):
                wfuts.append(writers.submit(
                    write_gzip_exact, out_paths[idx], raw, 9))

            sketch_fof(list(zip(sss, entries)), on_result=write_result)
            for fut in wfuts:
                fut.result()
        with open(out_fof_name, "w") as out_fof:
            for path, ss, buf in zip(entries, sss, bufs):
                out_fof.write(get_out_name(path, o["p"]) + ".gz\n")
                if o["v"]:
                    print_stat(ss, buf)
                sys.stdout.write(buf.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
