"""Virtual-mesh overhead probe for the sharded comparator (bench.py
runs this in a CPU subprocess with 8 forced host devices).

On one host all 8 virtual devices share the same cores, so this does
NOT measure multi-card scaling (that needs real cards); it measures
the overhead the shard_map + cross-device sum decomposition adds over
the single-device program on identical hardware — t8/t1 near 1.0
means the sharded program wastes nothing.

Prints one JSON line: {"t1_s":..., "t8_s":..., "overhead_ratio":...}.
"""

import json
import time

import numpy as np


def main():
    from supersampler_tpu.parallel.compare_dist import score_matrix_device
    from supersampler_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)
    G, F, dup = 1 << 20, 16, 3
    gids = np.repeat(np.arange(G, dtype=np.int32), dup)
    fids = rng.integers(0, F, gids.size).astype(np.int32)

    def best(mesh):
        score_matrix_device(gids, fids, G, F, mesh=mesh)   # warm
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            score_matrix_device(gids, fids, G, F, mesh=mesh)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t1 = best(None)
    t8 = best(make_mesh())
    print(json.dumps({"t1_s": round(t1, 4), "t8_s": round(t8, 4),
                      "overhead_ratio": round(t8 / t1, 3),
                      "note": "virtual 8-device CPU mesh shares one "
                              "host's cores; ~1.0 = shard_map+psum "
                              "adds no overhead"}))


if __name__ == "__main__":
    main()
