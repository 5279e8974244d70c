"""Diagnose WHY the heavy-tail chr21 reads overflow the deep tiers.

Loads the cached chr21 world, computes D bounds, difficulty-sorts, takes
the hardest --n reads, and runs them at a given (B, cap) tier config,
reporting per-lane: overflow flag, n_alns (acap saturation), n_pushed
(frame usage vs NFRAME), plus the global iteration count.  This separates
the three failure modes: frame exhaustion / acap saturation / timeout.

Run: python benchmarks/diag_tail.py [--n 512] [--B 128] [--cap 2097152]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def arg(name, default):
    if name in sys.argv:
        return int(sys.argv[sys.argv.index(name) + 1])
    return default


def main():
    N = arg("--n", 512)
    B = arg("--B", 128)
    cap = arg("--cap", 2097152)
    acap = arg("--acap", 64)
    kx = arg("--kx", 16)
    skip = arg("--skip", 0)          # exclude the hardest `skip` reads
    max_iters = arg("--max-iters", 500_000)
    run_all = "--all" in sys.argv

    import bench as benchmod
    from bwbble_tpu.align.params import AlnParams
    from bwbble_tpu.engine.device_index import from_fmindex
    from bwbble_tpu.engine.inexact import EngineConfig, inexact_search
    from bwbble_tpu.engine.pipeline import calc_d_all, difficulty_scores

    idx, reads, _ = benchmod.build_world()
    n_all = min(benchmod.CHR21_BENCH_READS, reads.count)
    from bwbble_tpu.formats.fastq import Reads
    reads = Reads(names=reads.names[:n_all], seq=reads.seq[:n_all],
                  rc=reads.rc[:n_all], qual=reads.qual[:n_all],
                  lengths=reads.lengths[:n_all])
    didx = from_fmindex(idx)
    params = AlnParams(max_diff=4, batch_size=1024)

    t0 = time.time()
    D_all, Ds_all, dov = calc_d_all(didx, reads, params, batch=1024,
                                    d_cap=64, host_idx=idx)
    z = difficulty_scores(didx, reads, params, D_all=D_all)
    order = np.argsort(z, kind="stable")
    if skip:
        order = order[:-skip]
    hard = order[::-1] if run_all else order[-N:]
    N = hard.size
    print(f"dbounds {time.time() - t0:.1f}s; hardest {N} reads; "
          f"difficulty z range [{z[hard[0]]}, {z[hard[-1]]}]")

    cfg = EngineConfig(cap=cap, acap=acap, kx=kx, max_iters=max_iters)
    NSLOT = 23
    NFRAME = (cap - 1) // NSLOT - 1
    Lmax = reads.max_len
    over_frame = over_acap = over_other = done_ok = 0
    push_hist = []
    for s in range(0, N, B):
        sel = hard[s:s + B]
        rc = np.zeros((B, Lmax), dtype=np.int8)
        rc[:len(sel)] = reads.rc[sel]
        ln = np.zeros((B,), dtype=np.int32)
        ln[:len(sel)] = reads.lengths[sel]
        Dsel = jnp.take(D_all, jnp.asarray(sel.astype(np.int32)), axis=0)
        Dssel = jnp.take(Ds_all, jnp.asarray(sel.astype(np.int32)), axis=0)
        t0 = time.time()
        res = inexact_search(didx, jnp.asarray(rc), jnp.asarray(ln),
                             Dsel, Dssel, params, cfg)
        jax.block_until_ready(res["n_alns"])
        dt = time.time() - t0
        ov = np.asarray(res["overflow"])[:len(sel)]
        na = np.asarray(res["n_alns"])[:len(sel)]
        npu = np.asarray(res["n_pushed"])[:len(sel)]
        iters = int(np.asarray(res["iters"]))
        for b in range(len(sel)):
            if not ov[b]:
                done_ok += 1
                push_hist.append(int(npu[b]))
            elif npu[b] >= NFRAME - 1:
                over_frame += 1
            elif na[b] >= cfg.acap:
                over_acap += 1
            else:
                over_other += 1
        print(f"launch@{s}: {dt:.1f}s iters={iters} "
              f"ok={int((~ov).sum())} over={int(ov.sum())} "
              f"n_pushed[min/med/max]={int(npu.min())}/"
              f"{int(np.median(npu))}/{int(npu.max())} "
              f"n_alns[med/max]={int(np.median(na))}/{int(na.max())}")
    print(f"TOTAL ok={done_ok} frame_over={over_frame} "
          f"acap_over={over_acap} other_over={over_other} "
          f"NFRAME={NFRAME}")
    if push_hist:
        ph = np.array(push_hist)
        print(f"pushes of resolved: med={np.median(ph):.0f} "
              f"p90={np.percentile(ph, 90):.0f} max={ph.max()}")


if __name__ == "__main__":
    main()
