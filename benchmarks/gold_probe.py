"""Per-read native-gold timing across the chr21 difficulty spectrum.

Samples reads at several difficulty ranks and times align_read_gold on
each, printing one line per read immediately (so timeouts still inform).

Run: JAX_PLATFORMS=cpu python benchmarks/gold_probe.py [--per 8]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    per = 8
    if "--per" in sys.argv:
        per = int(sys.argv[sys.argv.index("--per") + 1])

    import bench as benchmod
    from bwbble_tpu.align.params import AlnParams
    from bwbble_tpu.align.pipeline import align_read_gold
    from bwbble_tpu.engine.device_index import from_fmindex
    from bwbble_tpu.engine.pipeline import calc_d_all, difficulty_scores

    t0 = time.time()
    idx, reads, _ = benchmod.build_world()
    n = min(benchmod.CHR21_BENCH_READS, reads.count)
    from bwbble_tpu.formats.fastq import Reads
    reads = Reads(names=reads.names[:n], seq=reads.seq[:n],
                  rc=reads.rc[:n], qual=reads.qual[:n],
                  lengths=reads.lengths[:n])
    print(f"world loaded {time.time()-t0:.1f}s", flush=True)

    t0 = time.time()
    idx.bit_planes()
    print(f"bit_planes {time.time()-t0:.1f}s", flush=True)

    params = AlnParams(max_diff=4, batch_size=1024)
    t0 = time.time()
    didx = from_fmindex(idx)
    D_all, Ds_all, dov_all = calc_d_all(didx, reads, params, batch=1024,
                                        d_cap=64, host_idx=idx)
    order = np.flatnonzero(~dov_all).astype(np.int64)
    z = difficulty_scores(didx, reads, params, D_all=D_all)
    order = order[np.argsort(z[order], kind="stable")]
    print(f"dbounds+order {time.time()-t0:.1f}s n={order.size}", flush=True)

    ranks = [0, 64, 256, 1024, 2048, 4096, 6144, order.size - per]
    for r in ranks:
        times = []
        pops = []
        for j in range(per):
            i = int(order[r + j])
            t0 = time.time()
            alns = align_read_gold(idx, reads.seq[i], reads.rc[i],
                                   int(reads.lengths[i]), params)
            dt = time.time() - t0
            times.append(dt)
            print(f"rank={r+j} read={i} dt={dt*1e3:.1f}ms "
                  f"nalns={len(alns)}", flush=True)
        print(f"RANK {r}: mean={np.mean(times)*1e3:.1f}ms "
              f"max={np.max(times)*1e3:.1f}ms", flush=True)


if __name__ == "__main__":
    main()
