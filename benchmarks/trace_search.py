"""Capture a jax-profiler trace of one inexact_search launch and print the
per-op time table (evidence before optimization).

Run: python benchmarks/trace_search.py [outdir]
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import sys
from collections import defaultdict

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def summarize(outdir: str, top: int = 40):
    files = glob.glob(os.path.join(outdir, "**", "*.trace.json.gz"),
                      recursive=True)
    if not files:
        print("no trace files found under", outdir)
        return
    path = max(files, key=os.path.getmtime)
    with gzip.open(path, "rt") as f:
        trace = json.load(f)
    # keep only TensorFlow-op / XLA-op events on device threads
    by_name: dict[str, float] = defaultdict(float)
    cnt: dict[str, int] = defaultdict(int)
    total = 0.0
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        name = ev.get("name", "")
        dur = float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        # device-side XLA ops carry run ids / hlo info; host python ops don't
        if "run_id" in args or "program_id" in args or name.startswith(
                ("fusion", "gather", "dynamic", "copy", "while", "scatter",
                 "reduce", "dot", "convert", "select", "iota", "broadcast",
                 "concatenate", "slice", "transpose", "bitcast", "popcnt",
                 "all-reduce", "custom-call")):
            key = name.split(".")[0]
            by_name[key] += dur
            cnt[key] += 1
            total += dur
    print(f"trace: {path}")
    print(f"total device op time: {total / 1e3:.1f} ms")
    for name, dur in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{dur / 1e3:10.2f} ms  x{cnt[name]:<6d} {name[:90]}")


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/jaxtrace"
    import bench as benchmod
    from bwbble_tpu.align.params import AlnParams
    from bwbble_tpu.engine.device_index import from_fmindex
    from bwbble_tpu.engine.dbound import calc_d
    from bwbble_tpu.engine.inexact import EngineConfig, inexact_search

    idx, reads = benchmod.build_world()
    didx = from_fmindex(idx)
    B = 8192
    params = AlnParams(max_diff=4, batch_size=B)
    cfg = EngineConfig(cap=32768, acap=24, kx=2, max_iters=500_000)

    seq = jnp.asarray(reads.seq[:B].astype(np.int8))
    rc = jnp.asarray(reads.rc[:B].astype(np.int8))
    lengths_np = reads.lengths[:B].astype(np.int32)
    lengths = jnp.asarray(lengths_np)
    D, _ = calc_d(didx, seq, lengths, K=16)
    sl = jnp.asarray(np.where(lengths_np > 32, 32, 0).astype(np.int32))
    Ds, _ = calc_d(didx, seq, sl, K=16, max_len=32)
    # warm (compile) outside the trace
    res = inexact_search(didx, rc, lengths, D, Ds, params, cfg)
    jax.block_until_ready(res)

    with jax.profiler.trace(outdir):
        res = inexact_search(didx, rc, lengths, D, Ds, params, cfg)
        jax.block_until_ready(res)
    print("iters:", int(np.asarray(res["iters"])))
    summarize(outdir)


if __name__ == "__main__":
    main()
