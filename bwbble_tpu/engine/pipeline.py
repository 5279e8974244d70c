"""Device alignment pipeline: batches reads onto the device engines and falls
back to the host gold engine per read on any capacity overflow, so output is
byte-identical to the reference at every capacity setting.

Throughput structure:
- reads are ordered by a cheap difficulty proxy before batching, so lockstep
  batches are homogeneous (the per-batch iteration count is the max over
  lanes);
- batches are dispatched ahead of collection (a small in-flight window), so
  host assembly and device<->host transfers overlap the next batch's compute;
- optional escalation tiers (first_cap) and continuous batching (queued):
  both preserve bit-exact results; see align_reads_device for when each
  wins.  Overflowing reads always fall back to the host gold engine.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time as _tm
from collections import deque

# BWBBLE_TRACE=1: live per-phase/per-launch timings on stderr
_TRACE = bool(int(os.environ.get("BWBBLE_TRACE", "0")))


def _tr(msg: str) -> None:
    if _TRACE:
        sys.stderr.write(f"[pipeline +{_tm.monotonic():.1f}s] {msg}\n")
        sys.stderr.flush()

import numpy as np
import jax.numpy as jnp

from bwbble_tpu.align.params import AlnParams
from bwbble_tpu.align.pipeline import align_read_gold
from bwbble_tpu.engine.device_index import DeviceIndex
from bwbble_tpu.engine.dbound import calc_d, calc_d_1to1
from bwbble_tpu.engine.inexact import (EngineConfig, inexact_search,
                                       inexact_search_queued, unpack_paths,
                                       walk_paths)
from bwbble_tpu.formats.fastq import Reads
from bwbble_tpu.gold.engine import Aln
from bwbble_tpu.index.fmindex import FMIndex


def _reconstruct_path(rev_row: np.ndarray, plen: int, out_len: int,
                      root_plen: int) -> bytes:
    """Rebuild a push-order state path from the device's reverse-order walk
    buffer.  rev_row[t] is the state of the t-th ancestor (node first, root
    excluded); the root's implicit all-match prefix (root_plen zeros) and
    the exact-completion tail (out_len - plen zeros) are match states
    (STATE_M == 0)."""
    chain = bytes(rev_row[:max(plen - root_plen, 0)][::-1])
    path = bytes(root_plen) + chain
    if out_len > len(path):
        path = path + bytes(out_len - len(path))
    return path[:out_len]


def _calc_d_chunk(didx, seq, lengths, lengths_np, params, K):
    """D and D_seed for one padded chunk at interval capacity K; returns
    (D, Ds, overflow) device arrays.  lengths_np mirrors `lengths` for
    host-side masking."""
    seed_len = int(params.seed_length)
    if params.is_multiref:
        D, dov1 = calc_d(didx, seq, lengths, K=K)
    else:
        D, dov1 = calc_d_1to1(didx, seq, lengths)
    use_seed = (lengths_np > seed_len) & (seed_len > 0)
    sl = jnp.asarray(np.where(use_seed, seed_len, 0).astype(np.int32))
    if params.is_multiref:
        Ds, dov2 = calc_d(didx, seq, sl, K=K, max_len=max(seed_len, 1))
    else:
        Ds, dov2 = calc_d_1to1(didx, seq, sl, max_len=max(seed_len, 1))
    # reads not using a seed keep an all-zero D_seed (calloc semantics,
    # inexact_match.c:36,62-64)
    use_seed_d = jnp.asarray(use_seed)
    Ds = jnp.where(use_seed_d[:, None, None], Ds, 0)
    return D, Ds, dov1 | (dov2 & use_seed_d)


def probe_native_d(didx: DeviceIndex, reads: Reads, params: AlnParams,
                   d_cap: int, k_fast: int = 2, host_idx: FMIndex | None
                   = None, mesh=None) -> tuple[int, bool]:
    """(K1, skip): K1 is the device D pass's first-try interval capacity,
    skip=True when the whole device pass should be bypassed for the native
    exact scanner.

    Pure-ACGT references keep lists at width ~1 (k_fast=2 suffices); on
    IUPAC multi-genomes the scan's wide phase carries dozens of disjoint
    intervals on EVERY read, so a tiny first pass is pure waste — probe
    one chunk at k_fast and escalate the DEFAULT width if it overflows.
    When even d_cap overflows on >90% of the probe chunk (hundreds of
    disjoint intervals per read), the whole K=d_cap device pass would be
    discarded wholesale for the native scanner, so skip it up front."""
    NR = reads.count
    Lmax = max(reads.max_len, 1)
    K1 = min(k_fast, d_cap) if params.is_multiref else d_cap
    if not (params.is_multiref and NR > 0 and d_cap > K1):
        return K1, False
    nat_ok = False
    if host_idx is not None and mesh is None:
        from bwbble_tpu.native import get_native
        _natp = get_native()
        nat_ok = (_natp is not None and getattr(_natp, "_has_calc_d", False)
                  and host_idx.length == int(didx.length))
    sq = np.zeros((min(256, max(NR, 1)), Lmax), dtype=np.int8)
    nbp = min(256, NR, sq.shape[0])
    sq[:nbp, :reads.seq.shape[1]] = reads.seq[:nbp]
    lnp = np.zeros((sq.shape[0],), dtype=np.int32)
    lnp[:nbp] = reads.lengths[:nbp]
    if mesh is None:
        _, _, dovp = _calc_d_chunk(didx, jnp.asarray(sq),
                                   jnp.asarray(lnp), lnp, params, K1)
    else:
        from bwbble_tpu.parallel.shard import sharded_calc_d_chunk
        _, _, dovp = sharded_calc_d_chunk(mesh, didx, jnp.asarray(sq),
                                          jnp.asarray(lnp), params, K1)
    if np.asarray(dovp)[:nbp].mean() > 0.5:
        K1 = d_cap
        if nat_ok:
            _, _, dovp2 = _calc_d_chunk(didx, jnp.asarray(sq),
                                        jnp.asarray(lnp), lnp, params,
                                        d_cap)
            if np.asarray(dovp2)[:nbp].mean() > 0.9:
                return K1, True
    return K1, False


def calc_d_all(didx: DeviceIndex, reads: Reads, params: AlnParams,
               batch: int, d_cap: int = 16, k_fast: int = 2, mesh=None,
               host_idx: FMIndex | None = None, on_chunk=None):
    """D/D_seed bounds for every read: one cheap K=k_fast pass (exact unless
    a read's interval list overflows k_fast slots), then a K=d_cap re-run
    for just the overflowing reads.  Returns (D_all, Ds_all device arrays,
    overflow np.bool_[NR] — reads still overflowing at d_cap).

    `on_chunk(global_idx, z)`: called after each chunk with the chunk's
    read indices and difficulty scores (same formula as
    difficulty_scores) — lets the caller start routing work (e.g. the
    overlapped gold pool) while later chunks still run.  May return the
    indices it routed away; routed reads are skipped by the exact native
    scan (the gold engine recomputes D itself).

    The reference recomputes these per read with unbounded linked lists
    (calculate_d, inexact_match.c:171-254); a narrow fixed-capacity sweep
    covers almost all reads at an 8x lower rank-query volume, and doubles
    as the difficulty proxy used to order reads before batching.
    """
    NR = reads.count
    Lmax = max(reads.max_len, 1)
    K1, skip = probe_native_d(didx, reads, params, d_cap, k_fast,
                              host_idx, mesh)
    if skip:
        return _calc_d_native_all(didx, host_idx, reads, params,
                                  batch, on_chunk)
    if mesh is not None:
        from bwbble_tpu.parallel.shard import sharded_calc_d_chunk

        def chunk(sq, ln, ln_np, K):
            return sharded_calc_d_chunk(mesh, didx, sq, ln, params, K)
    else:
        def chunk(sq, ln, ln_np, K):
            return _calc_d_chunk(didx, sq, ln, ln_np, params, K)
    D_parts, Ds_parts, dov_parts = [], [], []
    _tr(f"calc_d_all: NR={NR} batch={batch} K1={K1}")
    for s in range(0, NR, batch):
        e = min(s + batch, reads.count)
        nb = e - s
        sq = np.zeros((batch, Lmax), dtype=np.int8)
        sq[:nb, :reads.seq.shape[1]] = reads.seq[s:e]
        ln = np.zeros((batch,), dtype=np.int32)
        ln[:nb] = reads.lengths[s:e]
        _tc = _tm.monotonic()
        D, Ds, dov = chunk(jnp.asarray(sq), jnp.asarray(ln), ln, K1)
        _tr(f"calc_d chunk @{s}: {_tm.monotonic() - _tc:.2f}s")
        D_parts.append(D[:nb])
        Ds_parts.append(Ds[:nb])
        dov_parts.append(np.asarray(dov)[:nb])
        if on_chunk is not None:
            zc = np.asarray(-64.0 * jnp.sum(
                jnp.log2(1.0 + D[:nb, :, 1].astype(jnp.float32)), axis=1)
                ).astype(np.int64)
            on_chunk(np.arange(s, e, dtype=np.int64), zc)
    D_all = jnp.concatenate(D_parts) if len(D_parts) > 1 else D_parts[0]
    Ds_all = jnp.concatenate(Ds_parts) if len(Ds_parts) > 1 else Ds_parts[0]
    dov_all = np.concatenate(dov_parts)

    retry = np.flatnonzero(dov_all)
    if retry.size and d_cap > K1:
        dov_all = np.zeros(NR, dtype=bool)
        for rs in range(0, retry.size, batch):
            sub = retry[rs:rs + batch]
            sel = np.concatenate([sub, np.full(batch - sub.size, sub[0],
                                               dtype=sub.dtype)])
            sq = np.zeros((batch, Lmax), dtype=np.int8)
            sq[:, :reads.seq.shape[1]] = reads.seq[sel]
            ln = reads.lengths[sel].astype(np.int32)
            D, Ds, dov = chunk(jnp.asarray(sq), jnp.asarray(ln), ln, d_cap)
            sidx = jnp.asarray(sub.astype(np.int32))
            n = sub.size
            D_all = D_all.at[sidx].set(D[:n])
            Ds_all = Ds_all.at[sidx].set(Ds[:n])
            dov_all[sub] = np.asarray(dov)[:n]

    # final escalation: reads whose interval lists exceed even d_cap slots
    # (IUPAC-dense multi-genomes reach thousands of disjoint intervals in
    # the scan's wide phase) get exact D bounds from the native unbounded-
    # list scanner, so D overflow never forces whole-read gold fallback
    still = np.flatnonzero(dov_all)
    _tr(f"calc_d_all: native escalation for {still.size} reads")
    if still.size and params.is_multiref:
        from bwbble_tpu import constants as CN
        from bwbble_tpu.native import get_native
        nat = get_native()
        if nat is not None and getattr(nat, "_has_calc_d", False):
            nb = np.ascontiguousarray(CN.NUCL_BASES, dtype=np.uint8)
            if host_idx is not None and host_idx.length == int(didx.length):
                planes = host_idx.bit_planes()
                fused = host_idx.fused_planes()
                seed_len = int(params.seed_length)
                np_dt = np.dtype(str(D_all.dtype))
                Dp = np.zeros((still.size,) + D_all.shape[1:], dtype=np_dt)
                Dsp = np.zeros((still.size,) + Ds_all.shape[1:], dtype=np_dt)
                for t, r in enumerate(still):
                    ln_r = int(reads.lengths[r])
                    dr = nat.calc_d_multiref(
                        planes, host_idx.occ, host_idx.Carr,
                        host_idx.length, host_idx.sa0, CN.OCC_INTERVAL, nb,
                        reads.seq[r], ln_r, fused=fused)
                    Dp[t, :ln_r + 1] = dr
                    if ln_r > seed_len and seed_len > 0:
                        ds = nat.calc_d_multiref(
                            planes, host_idx.occ, host_idx.Carr,
                            host_idx.length, host_idx.sa0, CN.OCC_INTERVAL,
                            nb, reads.seq[r], seed_len, fused=fused)
                        Dsp[t, :seed_len + 1] = ds
                sidx = jnp.asarray(still.astype(np.int32))
                D_all = D_all.at[sidx].set(jnp.asarray(Dp))
                Ds_all = Ds_all.at[sidx].set(jnp.asarray(Dsp))
                dov_all[still] = False
    return D_all, Ds_all, dov_all


def native_scan_chunks(host_idx: FMIndex, reads: Reads, params: AlnParams,
                       batch: int, np_dt=np.int32):
    """Generator: exact D/D_seed bounds from the native unbounded-list
    scanner (the reference's calculate_d semantics at any interval-list
    width, inexact_match.c:171-254), one `batch`-read chunk at a time.
    Yields (indices, D_chunk, Ds_chunk, difficulty).

    The difficulty proxy comes from the EXACT scanned widths — a clipped
    device pass (K=8) was tried as the routing signal and underestimated
    the hardest reads badly enough that one mis-routed read serialized a
    whole primary-tier launch (exact-completion chars share the lockstep
    iteration clock with pops)."""
    from bwbble_tpu import constants as CN
    from bwbble_tpu.native import get_native
    nat = get_native()
    if nat is None or not getattr(nat, "_has_calc_d", False):
        raise RuntimeError(
            "native_scan_chunks needs the native D-bound scanner: build it "
            "with `python -m bwbble_tpu.build_native`")
    NR = reads.count
    Lmax = max(reads.max_len, 1)
    seed_len = int(params.seed_length)
    nb_tab = np.ascontiguousarray(CN.NUCL_BASES, dtype=np.uint8)
    planes = host_idx.bit_planes()
    fused = host_idx.fused_planes()
    for s in range(0, NR, batch):
        e = min(s + batch, NR)
        Dch = np.zeros((e - s, Lmax + 1, 2), dtype=np_dt)
        Dsch = np.zeros((e - s, max(seed_len, 1) + 1, 2), dtype=np_dt)
        for r in range(s, e):
            ln_r = int(reads.lengths[r])
            dr = nat.calc_d_multiref(
                planes, host_idx.occ, host_idx.Carr, host_idx.length,
                host_idx.sa0, CN.OCC_INTERVAL, nb_tab, reads.seq[r], ln_r,
                fused=fused)
            Dch[r - s, :ln_r + 1] = dr
            if ln_r > seed_len and seed_len > 0:
                ds = nat.calc_d_multiref(
                    planes, host_idx.occ, host_idx.Carr, host_idx.length,
                    host_idx.sa0, CN.OCC_INTERVAL, nb_tab, reads.seq[r],
                    seed_len, fused=fused)
                Dsch[r - s, :seed_len + 1] = ds
        zc = (-64.0 * np.sum(
            np.log2(1.0 + Dch[:, :, 1].astype(np.float64)), axis=1)
            ).astype(np.int64)
        yield np.arange(s, e, dtype=np.int64), Dch, Dsch, zc


def _calc_d_native_all(didx: DeviceIndex, host_idx: FMIndex, reads: Reads,
                       params: AlnParams, batch: int, on_chunk=None):
    """Materialized native_scan_chunks: exact D bounds for every read,
    with `on_chunk` routing as each chunk lands."""
    NR = reads.count
    Lmax = max(reads.max_len, 1)
    seed_len = int(params.seed_length)
    np_dt = np.int64 if str(didx.idt) == "int64" else np.int32
    _tr("calc_d_all: device pass skipped (d_cap probe overflow); "
        "native exact scan")
    D_np = np.zeros((NR, Lmax + 1, 2), dtype=np_dt)
    Ds_np = np.zeros((NR, max(seed_len, 1) + 1, 2), dtype=np_dt)
    _t0 = _tm.monotonic()
    for gi, Dch, Dsch, zc in native_scan_chunks(host_idx, reads, params,
                                                batch, np_dt):
        D_np[gi[0]:gi[-1] + 1] = Dch
        Ds_np[gi[0]:gi[-1] + 1] = Dsch
        if on_chunk is not None:
            on_chunk(gi, zc)
    _tr(f"calc_d_all: native exact scan {NR} reads "
        f"({_tm.monotonic() - _t0:.2f}s)")
    return (jnp.asarray(D_np), jnp.asarray(Ds_np),
            np.zeros(NR, dtype=bool))


def difficulty_scores(didx: DeviceIndex, reads: Reads, params: AlnParams,
                      batch: int = 8192, K: int = 4,
                      D_all: jnp.ndarray | None = None) -> np.ndarray:
    """Cheap per-read difficulty proxy, derived for free from the D pass.

    Measured on the chr21 multi-genome worlds: search work ANTI-correlates
    with SA-interval width (wide intervals => the read matches many loci,
    finds its best quickly and max_best stops it; narrow => deep lonely
    exploration).  The proxy is therefore the NEGATED total log-width, so
    ascending order = easiest first."""
    if D_all is not None:
        w = jnp.sum(jnp.log2(1.0 + D_all[:, :, 1].astype(jnp.float32)),
                    axis=1)
        return np.asarray(-w * 64.0).astype(np.int64)
    out = np.zeros(reads.count, dtype=np.int64)
    for s in range(0, reads.count, batch):
        e = min(s + batch, reads.count)
        seq = jnp.asarray(reads.seq[s:e].astype(np.int32))
        lengths = jnp.asarray(reads.lengths[s:e].astype(np.int32))
        if params.is_multiref:
            D, _ = calc_d(didx, seq, lengths, K=K)
        else:
            D, _ = calc_d_1to1(didx, seq, lengths)
        z = jnp.max(D[:, :, 0], axis=1)
        out[s:e] = np.asarray(z)
    return out


def device_params_ok(params: AlnParams, max_len: int) -> bool:
    """True when the device engine's packed-word domain covers `params`
    (meta1 layout: mm 5 bits, go 3, ge 4, i 8, plen 9; score buckets
    bounded).  Outside it — the reference accepts e.g. -o 7 or -n 31
    (main.c:100-117) — alignment routes to the host gold engine instead
    of tripping engine asserts."""
    nb = ((int(params.max_diff) + 1) * int(params.mm_score)
          + (int(params.max_gapo) + 1) * int(params.gapo_score)
          + (int(params.max_gape) + 1) * int(params.gape_score))
    return (int(params.max_diff) + 1 <= 31
            and int(params.max_gapo) + 1 <= 7
            and int(params.max_gape) + 1 <= 15
            and max_len <= 255
            and nb <= 1024)


def align_reads_device(idx: FMIndex, didx: DeviceIndex, reads: Reads,
                       params: AlnParams, cfg: EngineConfig | None = None,
                       d_cap: int = 32, stats: dict | None = None,
                       precalc=None, seed_slots: int = 32,
                       window: int = 2, sort_reads: bool = True,
                       first_cap: int | None = None,
                       queued: bool = False, qchunk: int = 2,
                       mesh=None,
                       deep_tiers: bool | None = None,
                       gold_overlap: bool | None = None) -> list[list[Aln]]:
    """Align all reads on the device; returns per-read alignment lists in
    the reference's discovery order (byte-parity with align_reads_inexact).

    `precalc`: optional align.precalc.PrecalcTable for `-P` seeding
    (inexact_match.c:50-57); reads whose seed list exceeds `seed_slots`
    fall back to the host gold engine.  `window`: batches kept in flight.
    `first_cap`: arena rows for the first escalation tier (None => single
    tier with cfg.cap).  `queued`: continuous batching (lanes stream reads
    from a global queue); bit-identical results, wins on heterogeneous
    read sets (difficulty-sorted fixed batches win on uniform ones).
    `deep_tiers`: force the narrow-lane escalation ladder on/off (None =>
    auto: off when the native gold engine is available, which currently
    beats the deep tiers on the heavy tail).
    `gold_overlap`: run the host gold fallback CONCURRENTLY with the
    device tiers (a forked worker pool chews overflowing reads while the
    host thread waits on device launches).  None => auto: on when the
    native gold engine is available and the read set spans multiple
    batches; overlapping it with device compute hides most of the tail's
    cost.
    """
    cfg = cfg or EngineConfig()
    if not device_params_ok(params, max(reads.max_len, 1)):
        counters = {"fallback_reads": reads.count, "retried_reads": 0,
                    "t_dbounds": 0.0, "gold_routed": True}
        if stats is not None:
            stats.update(counters)
        out: list = [None] * reads.count
        for orig, alns in gold_fallback_many(
                idx, reads, list(range(reads.count)), params, precalc,
                int(params.n_threads)).items():
            out[orig] = alns
        return out
    nw = 6 if str(didx.idt) == "int64" else 4
    if mesh is not None:
        # the mesh product path (dp reads x tp index shards) is the fixed-
        # batch pipeline with the sharded kernels; results are byte-
        # identical to single-device alignment
        if precalc is not None:
            raise NotImplementedError("--mesh with -P seeding not yet wired")
        queued = False
    if queued and reads.count > int(params.batch_size):
        return _align_queued(idx, didx, reads, params, cfg, d_cap, stats,
                             precalc, seed_slots, sort_reads, qchunk=qchunk)
    B = int(params.batch_size)
    nc = 11 if params.is_multiref else 4
    root_plen = int(params.precalc_len) if precalc is not None else 0
    counters = {"fallback_reads": 0, "retried_reads": 0}
    results: list = [None] * reads.count

    def run_tier(sel_all: np.ndarray | None, tier_cfg: EngineConfig,
                 tier_B: int, on_failed=None, sel_gen=None) -> list[int]:
        """Process reads[sel_all] with tier_cfg; fill `results` for resolved
        reads, return the original indices that overflowed.  `on_failed`
        (streaming gold overlap): called with each launch's overflow list
        as soon as it is known, while later launches still run.  `sel_gen`
        (scan+launch overlap): an iterator of launch index arrays pulled
        BETWEEN a launch's async dispatch and its blocking collect, so
        host work inside the iterator (the native D scan) runs while the
        device crunches the previous launch."""
        failed: list[int] = []

        def dispatch(sel: np.ndarray):
            nb = sel.shape[0]
            if nb < tier_B:
                # pad with copies of the first read: all batches share one
                # compiled shape.  collect() iterates b < nb only, so a
                # padded duplicate lane's results are never read and
                # cannot overwrite the real lane's entries.
                sel = np.concatenate(
                    [sel, np.full(tier_B - nb, sel[0], dtype=sel.dtype)])
            rc = np.zeros((tier_B, max(reads.max_len, 1)), dtype=np.int8)
            rc[:, :reads.rc.shape[1]] = reads.rc[sel]
            lengths = reads.lengths[sel].astype(np.int32)

            seeds = None
            seed_over = np.zeros((tier_B,), dtype=bool)
            if precalc is not None:
                from bwbble_tpu.align.precalc import read_indices
                ri = read_indices(rc, lengths, k=int(params.precalc_len))
                sL, sU, scnt, seed_over = precalc.lookup_batch(ri, seed_slots)
                seeds = (jnp.asarray(sL.astype(np.int32)),
                         jnp.asarray(sU.astype(np.int32)),
                         jnp.asarray(scnt))
            if isinstance(D_all, np.ndarray):
                Dsel = jnp.asarray(D_all[sel])
                Dssel = jnp.asarray(Ds_all[sel])
            else:
                selj = jnp.asarray(sel.astype(np.int32))
                Dsel = jnp.take(D_all, selj, axis=0)
                Dssel = jnp.take(Ds_all, selj, axis=0)
            if mesh is not None:
                from bwbble_tpu.parallel.shard import sharded_inexact_search
                res = sharded_inexact_search(
                    mesh, didx, jnp.asarray(rc), jnp.asarray(lengths),
                    Dsel, Dssel, params, tier_cfg)
            else:
                res = _run_batch(didx, jnp.asarray(rc), jnp.asarray(lengths),
                                 params, tier_cfg, seeds, Dsel, Dssel)
            return dict(nb=nb, sel=sel, lengths=lengths, res=res,
                        seed_over=seed_over, seeds=seeds,
                        pathcap=tier_cfg.pathcap or (rc.shape[1] + 32))

        def collect(h) -> None:
            res = h["res"]
            # mesh results broadcast iters per lane; max = wall clock
            counters["waves"] = (counters.get("waves", 0)
                                 + int(np.asarray(res["iters"]).max()))
            n_alns = np.asarray(res["n_alns"])
            overflow = np.asarray(res["overflow"]) | h["seed_over"]
            o = {k: np.asarray(v) for k, v in res.items()
                 if k.startswith("o_")}

            # paths for the reported alignments only: compact (lane, node)
            # pairs on the host, walk parent chains on device
            nroot = 1 if h["seeds"] is None else h["seeds"][0].shape[1]
            lanes_l, nodes_l, keys = [], [], []
            for b in range(h["nb"]):
                if overflow[b]:
                    continue
                for k in range(int(n_alns[b])):
                    lanes_l.append(b)
                    nodes_l.append(int(o["o_node"][b, k]))
                    keys.append((b, k))
            paths_rev = {}
            if "paths" in res:
                # mesh launches walk their paths where each lane's arena
                # lives (parallel/shard.py)
                pr = unpack_paths(np.asarray(res["paths"]), h["pathcap"])
                paths_rev = {key: pr[key] for key in keys}
            elif keys:
                W = len(keys)
                Wp = max(256, 1 << (W - 1).bit_length())
                lanes_a = np.zeros(Wp, dtype=np.int32)
                nodes_a = np.full(Wp, -1, dtype=np.int32)
                lanes_a[:W] = lanes_l
                nodes_a[:W] = nodes_l
                pr = np.asarray(walk_paths(
                    res["arena"], jnp.asarray(lanes_a),
                    jnp.asarray(nodes_a), nroot=nroot, nslot=1 + 2 * nc,
                    nc=nc, pathcap=h["pathcap"], nw=nw))
                for w, key in enumerate(keys):
                    paths_rev[key] = pr[w]

            sel = h["sel"]
            launch_failed: list[int] = []
            for b in range(h["nb"]):
                orig = int(sel[b])
                if overflow[b]:
                    launch_failed.append(orig)
                    continue
                alns = []
                for k in range(int(n_alns[b])):
                    out_len = int(o["o_len"][b, k])
                    path = _reconstruct_path(paths_rev[(b, k)],
                                             int(o["o_plen"][b, k]),
                                             out_len, root_plen)
                    alns.append(Aln(
                        score=int(o["o_score"][b, k]),
                        L=int(o["o_L"][b, k]), U=int(o["o_U"][b, k]),
                        num_mm=int(o["o_mm"][b, k]),
                        num_gapo=int(o["o_go"][b, k]),
                        num_gape=int(o["o_ge"][b, k]),
                        num_snps=int(o["o_snp"][b, k]) & 0xFF,
                        aln_length=out_len, path=path))
                results[orig] = alns
            failed.extend(launch_failed)
            if on_failed is not None and launch_failed:
                on_failed(launch_failed)

        if sel_gen is not None:
            # one arena in flight: dispatch launch k (async), pull the next
            # batch from the iterator (host-side scan), then block on k
            it = iter(sel_gen)
            nxt = next(it, None)
            while nxt is not None:
                t0 = _tm.monotonic()
                h = dispatch(nxt)
                t1 = _tm.monotonic()
                nxt = next(it, None)
                t2 = _tm.monotonic()
                collect(h)
                _tr(f"tier B={tier_B} stream: dispatch {t1 - t0:.2f}s "
                    f"scan {t2 - t1:.2f}s collect {_tm.monotonic() - t2:.2f}s")
            return failed
        # every in-flight batch holds a full arena (~cap*B*22 bytes); cap
        # the dispatch window so total arena footprint stays under HBM
        arena_bytes = int(tier_cfg.cap) * tier_B * 23
        win = window if arena_bytes < (2 << 30) else 0
        pending: deque = deque()
        for start in range(0, sel_all.shape[0], tier_B):
            t0 = _tm.monotonic()
            pending.append(dispatch(sel_all[start:start + tier_B]))
            t1 = _tm.monotonic()
            while len(pending) > win:
                collect(pending.popleft())
            _tr(f"tier B={tier_B} cap={tier_cfg.cap} launch@{start}: "
                f"dispatch {t1 - t0:.2f}s collect {_tm.monotonic() - t1:.2f}s")
        while pending:
            collect(pending.popleft())
        return failed

    # Overlapped gold fallback: fork a host worker pool that gold-aligns
    # overflowing reads WHILE the device runs (the host thread is mostly
    # blocked on device results, so the worker gets the core).  The pool
    # is forked BEFORE the D pass so pre-routed reads (below) keep it
    # busy during dbounds; hardest-first tier order then surfaces the
    # remaining overflow early.
    pool: _GoldPool | None = None
    if gold_overlap is None:
        from bwbble_tpu.native import get_native
        _nat0 = get_native()
        gold_overlap = (params.is_multiref and _nat0 is not None
                        and getattr(_nat0, "_has_gold", False)
                        and mesh is None and reads.count > B)
    if gold_overlap:
        try:
            pool = _GoldPool(idx, reads, params, precalc,
                             n_workers=max(1, int(params.n_threads)))
        except (OSError, ValueError):     # no fork / no processes
            pool = None

    # Pre-route the per-chunk hardest quantile straight to gold as each D
    # chunk lands (keeps the host pool busy during the D phase).  The 3/8
    # share is carried over untuned; deriving it from the fallback target
    # on the GPU is ROADMAP A2/C5.
    routed = np.zeros(reads.count, dtype=bool)
    route_frac = 0.375 if (pool is not None and sort_reads) else 0.0

    def _route_chunk(gi: np.ndarray, zc: np.ndarray):
        k = int(gi.size * route_frac)
        if k <= 0 or gi.size < 64:
            return None
        thr = np.partition(zc, -k)[-k]
        sel = gi[zc >= thr]
        routed[sel] = True
        pool.submit(sel)
        return sel

    import time as _time0

    # Streamed scan+launch overlap: when the d_cap probe shows the device
    # D pass would be discarded for the native scanner anyway (IUPAC-dense
    # multi-genomes) and the gold pool is up, the scan runs on the CPU
    # BETWEEN each launch's async dispatch and its blocking collect, so
    # the device starts crunching after ONE scanned chunk instead of after
    # the full D phase.  Each launch takes the hardest B pending reads
    # (LPT-ish: failures surface early and stream to the pool mid-run).
    if (pool is not None and sort_reads and mesh is None and precalc is None
            and probe_native_d(didx, reads, params, d_cap,
                               host_idx=idx)[1]):
        _t_d = _time0.time()
        np_dt = np.int64 if str(didx.idt) == "int64" else np.int32
        Lmax_s = max(reads.max_len, 1)
        seed_len_s = int(params.seed_length)
        D_all = np.zeros((reads.count, Lmax_s + 1, 2), dtype=np_dt)
        Ds_all = np.zeros((reads.count, max(seed_len_s, 1) + 1, 2),
                          dtype=np_dt)
        t_scan = [0.0]

        def _stream_batches():
            pend_i = np.empty(0, dtype=np.int64)
            pend_z = np.empty(0, dtype=np.int64)
            _ts = _tm.monotonic()
            for gi, Dch, Dsch, zc in native_scan_chunks(
                    idx, reads, params, B, np_dt):
                D_all[gi[0]:gi[-1] + 1] = Dch
                Ds_all[gi[0]:gi[-1] + 1] = Dsch
                _route_chunk(gi, zc)
                keep = ~routed[gi]
                pend_i = np.concatenate([pend_i, gi[keep]])
                pend_z = np.concatenate([pend_z, zc[keep]])
                while pend_i.size >= B:
                    topk = np.argpartition(pend_z, -B)[-B:]
                    sel = pend_i[topk]
                    m = np.ones(pend_i.size, dtype=bool)
                    m[topk] = False
                    pend_i, pend_z = pend_i[m], pend_z[m]
                    t_scan[0] += _tm.monotonic() - _ts
                    yield np.sort(sel)
                    _ts = _tm.monotonic()
            rorder = np.argsort(-pend_z, kind="stable")
            pend_i = pend_i[rorder]
            t_scan[0] += _tm.monotonic() - _ts
            for s0 in range(0, pend_i.size, B):
                yield pend_i[s0:s0 + B]

        try:
            t0s = _time0.time()
            failed = run_tier(None, cfg, B, on_failed=pool.submit,
                              sel_gen=_stream_batches())
            counters["prerouted"] = int(routed.sum())
            counters["streamed"] = True
            counters["t_dbounds"] = round(t_scan[0], 2)
            counters["tiers"] = [dict(
                B=B, cap=int(cfg.cap), reads=int(reads.count - routed.sum()),
                failed=len(set(failed)), sec=round(_time0.time() - t0s, 2))]
            # device-search wall time: the tier span minus the host scan
            # that ran interleaved inside it
            counters["t_search"] = round(
                max(_time0.time() - t0s - t_scan[0], 0.0), 2)
            counters["fallback_reads"] += pool.submitted
            t0 = _time0.time()
            for orig, alns in pool.drain().items():
                results[orig] = alns
            counters["t_host"] = round(_time0.time() - t0, 2)
            pool = None
        finally:
            if pool is not None:
                pool.terminate()
        if stats is not None:
            stats.update(counters)
        return results

    _t_d = _time0.time()
    D_all, Ds_all, dov_all = calc_d_all(
        didx, reads, params, batch=min(B, _pow2_at_least(reads.count)),
        d_cap=d_cap, mesh=mesh, host_idx=idx,
        on_chunk=_route_chunk if route_frac > 0 else None)
    counters["t_dbounds"] = round(_time0.time() - _t_d, 2)
    counters["prerouted"] = int(routed.sum())
    order = np.flatnonzero(~dov_all & ~routed).astype(np.int64)
    if sort_reads and reads.count > B and order.size:
        z = difficulty_scores(didx, reads, params, D_all=D_all)
        order = order[np.argsort(z[order], kind="stable")]

    if pool is not None:
        if sort_reads:
            order = order[::-1]
        dov_sel = np.flatnonzero(dov_all & ~routed)
        if dov_sel.size:
            pool.submit(dov_sel)

    # Escalation ladder: a launch of I iterations can host any read whose
    # total work (pops + exact chars) is <= NFRAME ~= cap/NSLOT, so a read's
    # on-device work budget rises as the lane count shrinks at constant
    # arena memory (cap * lanes ~= const).  Hard reads (repeat regions can
    # need 10^4-10^5 pops; the reference allows max_entries=3e6,
    # inexact_match.c:299) ladder down to narrow deep tiers instead of
    # storming the host gold engine.
    tiers: list[tuple[int, EngineConfig]] = []
    if first_cap is not None and first_cap < cfg.cap:
        tiers.append((B, dataclasses.replace(cfg, cap=int(first_cap))))
    tiers.append((B, cfg))
    # Deep narrow-lane tiers raise the per-read frame budget at constant
    # arena memory.  With the native gold engine present, hard reads go
    # straight to gold instead (the tail is serial-iteration-bound on a
    # lockstep body); the tiers remain for runs without it, where they
    # beat the Python gold engine.  Whether the ladder pays on the GPU, and
    # its shape, are untuned carry-overs: ROADMAP A2/C5.
    if deep_tiers is None:
        from bwbble_tpu.native import get_native
        _nat = get_native()
        deep_tiers = not (params.is_multiref and _nat is not None
                          and getattr(_nat, "_has_gold", False))
    cell = max(int(cfg.cap) * B, 1 << 25)     # arena rows x lanes budget
    ladder = ((1024, 8), (256, 8), (64, 16))
    for deep_B, deep_kx in (ladder if deep_tiers else ()):
        if deep_B < B:
            deep_cap = min(cell // deep_B, 4 << 20)
            tiers.append((deep_B, dataclasses.replace(
                cfg, cap=deep_cap, acap=max(cfg.acap, 64),
                kx=max(cfg.kx, deep_kx),
                max_iters=max(cfg.max_iters, deep_cap // 23 + 1024))))

    import time as _time
    tier_log: list[dict] = []
    sel = order
    try:
        for t, (tier_B_max, tier_cfg) in enumerate(tiers):
            if sel.shape[0] == 0:
                break
            if t > 0:
                counters["retried_reads"] += sel.shape[0]
            t0 = _time.time()
            stream = (pool.submit if pool is not None
                      and t == len(tiers) - 1 else None)
            failed = run_tier(sel, tier_cfg,
                              min(tier_B_max, _pow2_at_least(sel.shape[0],
                                                             lo=128)),
                              on_failed=stream)
            tier_log.append(dict(B=int(min(tier_B_max, _pow2_at_least(
                sel.shape[0], lo=128))), cap=int(tier_cfg.cap),
                reads=int(sel.shape[0]), failed=len(set(failed)),
                sec=round(_time.time() - t0, 2)))
            sel = np.array(sorted(set(failed)), dtype=np.int64)
        counters["tiers"] = tier_log
        counters["t_search"] = round(
            sum(t.get("sec", 0.0) for t in tier_log), 2)

        if pool is not None:
            # overflow (streamed per launch) and D-overflow reads were
            # already submitted; just wait for the workers
            counters["fallback_reads"] += pool.submitted
            t0 = _time.time()
            for orig, alns in pool.drain().items():
                results[orig] = alns
            counters["t_host"] = round(_time.time() - t0, 2)
            pool = None
        else:
            sel = np.concatenate([sel,
                                  np.flatnonzero(dov_all).astype(np.int64)])
            if sel.size:
                counters["fallback_reads"] += int(sel.size)
                for orig, alns in gold_fallback_many(
                        idx, reads, [int(i) for i in sel], params, precalc,
                        int(params.n_threads)).items():
                    results[orig] = alns
    finally:
        if pool is not None:
            pool.terminate()

    if stats is not None:
        stats.update(counters)
    return results


# host gold fallback, parallel over reads (the reference's -t semantics:
# OpenMP threads over an embarrassingly-parallel read loop,
# inexact_match.c:92-168).  Heavy state (index, reads, precalc) reaches the
# workers by fork copy-on-write, not pickling.
_FB_CTX: dict = {}


def _fb_worker(i: int):
    c = _FB_CTX
    return align_read_gold(c["idx"], c["reads"].seq[i], c["reads"].rc[i],
                           int(c["reads"].lengths[i]), c["params"],
                           precalc=c["precalc"])


class _GoldPool:
    """Forked host-gold worker pool that runs concurrently with device
    launches.  The pool is forked ONCE (heavy state — index, bit planes,
    reads — reaches workers by copy-on-write); later submissions only
    ship read indices.  Workers touch nothing but numpy + the native
    library, never the device client, so forking under a live JAX client
    is safe as long as the child does not touch JAX."""

    def __init__(self, idx, reads: Reads, params: AlnParams, precalc,
                 n_workers: int = 1):
        import multiprocessing as mp
        ctx = mp.get_context("fork")      # raises on fork-less platforms
        if params.is_multiref:
            idx.bit_planes()              # materialize BEFORE the fork
            idx.fused_planes()            # (copy-on-write shares both)
        _FB_CTX.update(idx=idx, reads=reads, params=params, precalc=precalc)
        try:
            self._pool = ctx.Pool(max(1, int(n_workers)))
        finally:
            _FB_CTX.clear()
        self._async: list = []
        self.submitted = 0

    def submit(self, sel) -> None:
        sel = [int(i) for i in sel]
        if not sel:
            return
        self.submitted += len(sel)
        self._async.append((sel, self._pool.map_async(
            _fb_worker, sel, chunksize=max(1, len(sel) // 8))))

    def drain(self) -> dict[int, list]:
        out: dict[int, list] = {}
        for sel, ar in self._async:
            for i, alns in zip(sel, ar.get()):
                out[i] = alns
        self._async = []
        self._pool.close()
        self._pool.join()
        return out

    def terminate(self) -> None:
        self._pool.terminate()
        self._pool.join()


def gold_fallback_many(idx, reads: Reads, sel: list[int], params: AlnParams,
                       precalc, n_threads: int) -> dict[int, list]:
    """Gold-align reads[sel]; with n_threads > 1 a fork pool spreads the
    reads over processes so overflow storms degrade gracefully instead of
    serializing on one interpreter."""
    if n_threads <= 1 or len(sel) <= 1:
        return {i: _fb_single(idx, reads, i, params, precalc) for i in sel}
    import multiprocessing as mp
    try:
        ctx = mp.get_context("fork")
    except ValueError:          # platform without fork: serial fallback
        return {i: _fb_single(idx, reads, i, params, precalc) for i in sel}
    _FB_CTX.update(idx=idx, reads=reads, params=params, precalc=precalc)
    try:
        with ctx.Pool(min(int(n_threads), len(sel))) as pool:
            outs = pool.map(_fb_worker, sel,
                            chunksize=max(1, len(sel) // (4 * n_threads)))
    finally:
        _FB_CTX.clear()
    return dict(zip(sel, outs))


def _fb_single(idx, reads, i, params, precalc):
    return align_read_gold(idx, reads.seq[i], reads.rc[i],
                           int(reads.lengths[i]), params, precalc=precalc)


def _pow2_at_least(n: int, lo: int = 256) -> int:
    return max(lo, 1 << (int(n) - 1).bit_length())


def _run_batch(didx, rc, lengths, params, cfg, seeds, D, Ds):
    """Dispatch one search batch with precomputed D bounds; returns the
    result dict of device arrays.  Nothing here blocks on device
    completion."""
    if seeds is None:
        return inexact_search(didx, rc, lengths, D, Ds, params, cfg)
    return inexact_search(didx, rc, lengths, D, Ds, params, cfg,
                          seed_L=seeds[0], seed_U=seeds[1],
                          seed_cnt=seeds[2])


def _align_queued(idx, didx, reads: Reads, params: AlnParams,
                  cfg: EngineConfig, d_cap: int, stats, precalc,
                  seed_slots: int, sort_reads: bool,
                  qchunk: int = 16) -> list:
    """Continuous batching: engine launches stream reads through a fixed
    set of lanes (hardest reads first — LPT scheduling), so the lockstep
    iteration count is (total pops / lanes)-bound instead of per-batch
    max-bound.

    The queue-mode arena is a RING (engine/inexact.py): every read gets a
    full cfg.cap frame budget from its own start, and parent chains are
    walked at flush time, so one launch can stream arbitrarily many reads.
    qchunk*lanes reads per launch keeps absolute node ids inside the
    24-bit packed-prev-link range.  Reads that overflow their per-read
    budget retry through the fixed-batch escalation ladder, and only
    persistent failures reach the host gold engine.
    """
    import time as _time
    t_start = _time.time()
    NR = reads.count
    lanes = min(int(params.batch_size), _pow2_at_least(NR, lo=256))
    nc = 11 if params.is_multiref else 4
    root_plen = int(params.precalc_len) if precalc is not None else 0

    # overlapped host-gold pool, forked BEFORE the D pass so pre-routed
    # reads keep the host core busy from the first scanned chunk onward
    pool: _GoldPool | None = None
    from bwbble_tpu.native import get_native
    _natq = get_native()
    if (params.is_multiref and _natq is not None
            and getattr(_natq, "_has_gold", False) and NR > lanes):
        try:
            pool = _GoldPool(idx, reads, params, precalc,
                             n_workers=max(1, int(params.n_threads)))
        except (OSError, ValueError):     # no fork / no processes
            pool = None

    # one forward D pass: search bounds + difficulty ordering + escalation.
    # The gold pool idles through the scan ON PURPOSE: on a one-core host,
    # overlapping the pool with the native scanner slowed the scan more
    # than the post-scan route below offloads.
    Dr_all, Dsr_all, dov_raw = calc_d_all(
        didx, reads, params, batch=min(lanes, _pow2_at_least(NR)),
        d_cap=d_cap, host_idx=idx)
    import jax as _jax
    _jax.block_until_ready((Dr_all, Dsr_all))
    t_dbounds = _time.time() - t_start
    if sort_reads:
        z = difficulty_scores(didx, reads, params, D_all=Dr_all)
        order = np.argsort(-z, kind="stable").astype(np.int64)
    else:
        order = np.arange(NR, dtype=np.int64)

    # Routing budget: DERIVED from the <5% fallback target (4.5% leaves
    # margin), not hand-tuned.  The top-z slice routes to gold in one
    # shot: the proxy's hardest reads are exactly the ones that would
    # burn the deepest ring budgets (a top-z read averages tens of
    # thousands of pops — 4.5% of reads carries ~25% of total device
    # work), and the ladder resolves everything else on-device, so the
    # pre-routed slice IS the fallback set.
    budget = int(0.045 * NR) if (pool is not None and sort_reads) else 0
    routed = np.zeros(NR, dtype=bool)
    if budget >= 32:
        pre = order[:budget]
        routed[pre] = True
        pool.submit([int(i) for i in pre])
    order = order[~(routed[order] | dov_raw[order])]
    dov_sel = np.flatnonzero(dov_raw & ~routed)
    if dov_sel.size and pool is not None:
        pool.submit(dov_sel)

    Lmax = max(reads.max_len, 1)
    pathcap = cfg.pathcap or (Lmax + 32)
    nslot = 1 + 2 * nc
    iter_cap = ((1 << 24) - 64) // nslot - 2
    out: list = [None] * NR
    iters_total = 0
    t_search = 0.0
    pass_log: list[dict] = []

    def ring_pass(sub: np.ndarray, lanes_p: int, cfg_p: EngineConfig,
                  qchunk_p: int) -> list[int]:
        """Stream reads[sub] (absolute ids, hardest-first) through the
        queued engine at lanes_p lanes; fills `out`, returns the ids that
        overflowed their per-read ring budget."""
        nonlocal iters_total, t_search
        NQ = sub.size
        rc_s = np.zeros((NQ, Lmax), dtype=np.int8)
        rc_s[:, :reads.rc.shape[1]] = reads.rc[sub]
        len_s = reads.lengths[sub].astype(np.int32)
        seeds_s = None
        seed_over = np.zeros((NQ,), dtype=bool)
        if precalc is not None:
            from bwbble_tpu.align.precalc import read_indices
            ri = read_indices(rc_s, len_s, k=int(params.precalc_len))
            sL, sU, scnt, seed_over = precalc.lookup_batch(ri, seed_slots)
            seeds_s = (sL.astype(np.int32), sU.astype(np.int32), scnt)
        subj = jnp.asarray(sub.astype(np.int32))
        D_s = jnp.take(Dr_all, subj, axis=0)
        Ds_s = jnp.take(Dsr_all, subj, axis=0)
        nroot = 1 if seeds_s is None else seeds_s[0].shape[1]
        nframe = max((int(cfg_p.cap) - nroot) // nslot - 1, 2)
        # per-launch size: qchunk_p*lanes reads, shrunk so the iteration
        # budget (each of ceil(Q/lanes) reads a lane serves can take up
        # to NFRAME pops) stays inside the 24-bit packed-prev-link range
        q_chunks = max(1, min(int(qchunk_p),
                              (iter_cap - 4096) // nframe - 2))
        Q = min(_pow2_at_least(NQ, lo=lanes_p), q_chunks * lanes_p)
        need = (Q // lanes_p + 2) * nframe + 4096
        cfg_r = dataclasses.replace(
            cfg_p,
            max_iters=min(max(int(cfg_p.max_iters), need), iter_cap))
        t0p = _time.time()
        it0 = iters_total
        failed_p: list[int] = []

        def dispatch(cs: int) -> dict:
            ce = min(cs + Q, NQ)
            nb = ce - cs
            if nb < Q:
                # pad with copies of the chunk's last (easiest) read so
                # every launch shares one compiled shape; padding rows
                # are ignored
                pad = np.concatenate(
                    [np.arange(cs, ce),
                     np.full(Q - nb, ce - 1)]).astype(np.int64)
            else:
                pad = np.arange(cs, ce, dtype=np.int64)
            padj = jnp.asarray(pad.astype(np.int32))
            kw = {}
            if seeds_s is not None:
                kw = dict(seed_L=jnp.asarray(seeds_s[0][pad]),
                          seed_U=jnp.asarray(seeds_s[1][pad]),
                          seed_cnt=jnp.asarray(seeds_s[2][pad]))
            res = inexact_search_queued(
                didx, jnp.asarray(rc_s[pad]), jnp.asarray(len_s[pad]),
                jnp.take(D_s, padj, axis=0), jnp.take(Ds_s, padj, axis=0),
                params, cfg_r, lanes=lanes_p, **kw)
            return dict(cs=cs, nb=nb, res=res)

        def collect_h(h: dict) -> None:
            """Block on the launch and extract the CHEAP outputs (failed
            ids, counters); the Python-side Aln assembly is deferred to
            `pending_assembly` so it can run while the NEXT pass computes
            on the device."""
            nonlocal iters_total, t_search
            cs, nb, res = h["cs"], h["nb"], h["res"]
            ce = cs + nb
            t_sq = _time.time()
            iters_total += int(np.asarray(res["iters"]))
            t_search += _time.time() - t_sq
            overflow = np.asarray(res["overflow"])[:nb] | seed_over[cs:ce]
            for r in np.flatnonzero(overflow):
                failed_p.append(int(sub[cs + r]))
            pending_assembly.append(dict(sub=sub, cs=cs, nb=nb, res=res,
                                         overflow=overflow))

        # one-launch lookahead: dispatch k+1 (async) before collecting k,
        # so per-launch host work overlaps the next launch's device
        # compute instead of serializing between launches
        pending: dict | None = None
        for cs in range(0, NQ, Q):
            h = dispatch(cs)
            # earlier passes' deferred Aln assembly runs here, hidden
            # under the launch just dispatched
            drain_assembly()
            if pending is not None:
                collect_h(pending)
            pending = h
        if pending is not None:
            collect_h(pending)
        pass_log.append(dict(B=lanes_p, cap=int(cfg_p.cap),
                             reads=int(NQ), failed=len(failed_p),
                             sec=round(_time.time() - t0p, 2),
                             waves=iters_total - it0))
        return failed_p

    pending_assembly: list[dict] = []

    def drain_assembly() -> None:
        """Build the Aln lists of every collected launch (Python-side;
        runs while a later pass occupies the device).  Bulk .tolist()
        first: Python-int indexing is ~10x cheaper than per-element
        numpy scalar fetches."""
        while pending_assembly:
            h = pending_assembly.pop(0)
            sub_h, cs, nb = h["sub"], h["cs"], h["nb"]
            res, overflow = h["res"], h["overflow"]
            n_alns = np.asarray(res["n_alns"])[:nb].tolist()
            oL = np.asarray(res["o_L"])[:nb].tolist()
            oU = np.asarray(res["o_U"])[:nb].tolist()
            oSc = np.asarray(res["o_score"])[:nb].tolist()
            oLen = np.asarray(res["o_len"])[:nb].tolist()
            oMM = np.asarray(res["o_mm"])[:nb].tolist()
            oGO = np.asarray(res["o_go"])[:nb].tolist()
            oGE = np.asarray(res["o_ge"])[:nb].tolist()
            oSnp = np.asarray(res["o_snp"])[:nb].tolist()
            oPl = np.asarray(res["o_plen"])[:nb].tolist()
            # paths were walked on-device at flush time (ring arena) and
            # ship 2-bit packed (4x less device->host traffic)
            paths_all = unpack_paths(np.asarray(res["paths"])[:nb],
                                     pathcap)
            sub_l = sub_h[cs:cs + nb].tolist()
            ov_l = overflow.tolist()
            for r in range(nb):
                if ov_l[r]:
                    continue
                alns = []
                for k in range(n_alns[r]):
                    out_len = oLen[r][k]
                    path = _reconstruct_path(paths_all[r, k],
                                             oPl[r][k], out_len,
                                             root_plen)
                    alns.append(Aln(
                        score=oSc[r][k], L=oL[r][k], U=oU[r][k],
                        num_mm=oMM[r][k], num_gapo=oGO[r][k],
                        num_gape=oGE[r][k], num_snps=oSnp[r][k] & 0xFF,
                        aln_length=out_len, path=path))
                out[sub_l[r]] = alns

    n_retry = 0
    try:
        # Escalation ladder, all rungs CONTINUOUS-BATCHING: the primary
        # pass at full lanes, then failures re-queue at narrower lanes
        # whose per-read ring budget grows at ~constant arena memory
        # (cap*lanes).  Reads that out-run even the deepest rung go to
        # the host gold pool, which has been chewing the pre-routed slice
        # concurrently the whole time.
        cell = max(int(cfg.cap) * lanes, 1 << 25)
        failed = ring_pass(order, lanes, cfg, qchunk)
        # one deep rung at the maximum per-read budget the arena allows
        # (cell/128 rows): an intermediate 256-lane/half-budget rung was
        # measured to fail on 72% of the primary's failures on the chr21
        # world — its whole budget re-paid at the deeper rung — so the
        # ladder goes straight to the deepest budget
        for deep_B in (128,):
            if not failed or deep_B >= lanes:
                continue
            n_retry += len(failed)
            deep_cap = min(cell // deep_B, 4 << 20)
            deep_cfg = dataclasses.replace(
                cfg, cap=deep_cap, acap=max(cfg.acap, 64),
                flush=min(int(cfg.flush), deep_B // 2))
            sub = np.array(sorted(set(failed)), dtype=np.int64)
            if sort_reads:
                sub = sub[np.argsort(-z[sub], kind="stable")]
            failed = ring_pass(sub, deep_B, deep_cfg, qchunk_p=16)
        if pool is not None and failed:
            pool.submit(sorted(set(failed)))
        drain_assembly()
        if pool is not None:
            n_fallback = pool.submitted
            for orig, alns in pool.drain().items():
                out[orig] = alns
            pool = None
        else:
            rest = sorted(set(failed)) + [int(i) for i in dov_sel]
            n_fallback = len(rest)
            if rest:
                for orig, alns in gold_fallback_many(
                        idx, reads, rest, params, precalc,
                        int(params.n_threads)).items():
                    out[orig] = alns
    finally:
        if pool is not None:
            pool.terminate()
    if stats is not None:
        stats.update(fallback_reads=n_fallback,
                     retried_reads=n_retry,
                     prerouted=int(routed.sum()),
                     iters=iters_total, waves=iters_total,
                     t_dbounds=round(t_dbounds, 3),
                     t_search=round(t_search, 3),
                     t_host=round(_time.time() - t_start - t_dbounds
                                  - t_search, 3),
                     tiers=pass_log)
    return out
