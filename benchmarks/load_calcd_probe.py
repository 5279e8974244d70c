"""Profile FMIndex.load and measure the native gold engine's calc_d share (candidate win: pass the
device-computed D bounds into the fallback workers).

Run: JAX_PLATFORMS=cpu python benchmarks/load_calcd_probe.py
"""

from __future__ import annotations

import cProfile
import io
import os
import pstats
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from bwbble_tpu.index.fmindex import FMIndex

    bwt = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".bench", "chr21", "mg_bubble.bwt")
    pr = cProfile.Profile()
    pr.enable()
    idx = FMIndex.load(bwt)
    pr.disable()
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(12)
    print(s.getvalue(), flush=True)

    t0 = time.time()
    idx.bit_planes()
    print(f"bit_planes {time.time()-t0:.1f}s", flush=True)

    import bench as benchmod
    from bwbble_tpu import constants as C
    from bwbble_tpu.align.params import AlnParams
    from bwbble_tpu.align.pipeline import align_read_gold
    from bwbble_tpu.native import get_native

    _, reads, _ = benchmod.build_world()
    nat = get_native()
    params = AlnParams(max_diff=4)
    nb = np.ascontiguousarray(C.NUCL_BASES, dtype=np.uint8)
    rng = np.random.default_rng(7)
    sample = rng.choice(8192, 48, replace=False)
    t_d = t_g = 0.0
    for i in sample:
        ln = int(reads.lengths[i])
        t0 = time.time()
        nat.calc_d_multiref(idx.bit_planes(), idx.occ, idx.Carr, idx.length,
                            idx.sa0, C.OCC_INTERVAL, nb, reads.seq[i], ln)
        nat.calc_d_multiref(idx.bit_planes(), idx.occ, idx.Carr, idx.length,
                            idx.sa0, C.OCC_INTERVAL, nb, reads.seq[i],
                            int(params.seed_length))
        t_d += time.time() - t0
        t0 = time.time()
        align_read_gold(idx, reads.seq[i], reads.rc[i], ln, params)
        t_g += time.time() - t0
    print(f"over {len(sample)} reads: calc_d(+seed) {t_d*1e3/len(sample):.2f}"
          f" ms/read; full gold {t_g*1e3/len(sample):.2f} ms/read "
          f"(calc_d share {100*t_d/max(t_g,1e-9):.0f}%)", flush=True)


if __name__ == "__main__":
    main()
