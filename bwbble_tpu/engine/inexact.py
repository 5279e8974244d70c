"""Lockstep inexact search engine (the reference's core algorithm on the
device).

Redesign of the score-bucketed best-first DFS (inexact_match,
inexact_match.c:256-506) for SIMD execution over a read batch, written as a
plain `lax.while_loop` that XLA compiles.  The hot loop contains no scatter
into per-lane state and no full-arena scans:

- **Dense frames.**  Each global iteration reserves one frame of NSLOT
  candidate rows in an append-only arena ([B, CAP] struct-of-arrays); slot s
  of the frame always holds expansion candidate s, valid or not, so every
  write is a `dynamic_update_slice` at a lane-uniform offset.  Node ids are
  therefore identical across lanes.  The 8 three-base IUPAC slots that quirk
  Q1 makes permanently empty (bwt.c:698-734) are dropped statically:
  NSLOT = 1 + 2*11 (multiref) or 1 + 2*4 (single-genome).
- **Score-bucket stacks.**  The reference heap (score buckets, LIFO within a
  bucket, pop = tail of best bucket; inexact_match.c:510-610) maps exactly
  onto per-lane bucket heads [B, NUM_BUCKETS] plus a per-node `prev` link:
  push = vectorized [B, NSLOT, NB] selects, pop = argmax over ~65 occupied
  flags + one gather.  Exploration order is bit-identical.
- **Packed node words.**  A node is 4 int32s: L, U, meta1
  (i|mm|go|ge|state|plen), meta2 (snps | prev+1 << 8); the parent id is
  stored once per frame.  Scores are recomputed from meta1 (3 multiplies)
  instead of stored.  Nodes live in 512-byte frame ROWS (arena
  [F, B, 128]: 23 slots x 4 words + parent id per lane-frame), so a pop is
  one row gather on the [F*B, 128] view + a dense slot select, and a frame
  write is one contiguous update slice.
- **Continuous batching (queue mode).**  Lockstep cost is the max over
  lanes, so fixed batches waste most lane-iterations on finished reads.
  With a read queue, a lane that finishes flushes its outputs to per-read
  result slabs and pulls the next read from a global counter inside the
  while loop — iteration count becomes (total pops / B)-bound instead of
  max-bound.  Per-read search state resets exactly, so results are
  bit-identical to fixed batching.
- **Device path reconstruction.**  Parent chains of the reported alignments
  are walked after the loop over a host-compacted (lane, node) list; a
  node's appended state is a static function of its frame slot.
- Per-lane state machine: each iteration a lane either pops+expands one DFS
  node, or advances its in-flight exact-completion scan (the
  exact_match_bounded call of inexact_match.c:345-375) by one character.
  Capacity overflow (frames/alignments/intervals) flags the read for
  host-gold fallback, so results remain byte-exact at any capacity setting.

Indices are int32 (single-shard genomes < 2^31 positions).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from bwbble_tpu import constants as C
from bwbble_tpu.align.params import AlnParams
from bwbble_tpu.engine.device_index import DeviceIndex
from bwbble_tpu.engine.intervals import expand_step
from bwbble_tpu.engine.rank import (rank1_pair, rank_actg_dfs_pair,
                                    rank_all_dfs_pair)

MODE_DFS, MODE_EXACT, MODE_DONE = 0, 1, 2

_MATCH = np.asarray(C.MATCH_MATRIX, dtype=np.int32)       # [5, 16]
_IS_SNP = np.asarray(C.IS_SNP, dtype=np.int32)
_GRAY4 = np.asarray(C.NT4_GRAY, dtype=np.int32)

# meta1 bit layout: i(8) | mm(5) | go(3) | ge(4) | st(2) | plen(9)
_SH_MM, _SH_GO, _SH_GE, _SH_ST, _SH_PLEN = 8, 13, 16, 20, 22


def _pack1(i, mm, go, ge, st, plen):
    return (i | (mm << _SH_MM) | (go << _SH_GO) | (ge << _SH_GE)
            | (st << _SH_ST) | (plen << _SH_PLEN))


def _unpack1(m):
    return (m & 0xFF, (m >> _SH_MM) & 0x1F, (m >> _SH_GO) & 0x7,
            (m >> _SH_GE) & 0xF, (m >> _SH_ST) & 0x3, (m >> _SH_PLEN) & 0x1FF)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    cap: int = 32768          # arena rows per lane (bounds DFS pops)
    acap: int = 24            # reported alignments per read
    kx: int = 4               # exact-completion interval slots per lane
    max_iters: int = 200_000  # lockstep safety bound
    pathcap: int = 0          # reported path length bound (0 => Lmax + 32)
    flush: int = 64           # queue mode: max reads flushed per iteration
    xsteps: int = 1           # exact-completion chars advanced per iteration


def _int(p, name):
    return int(getattr(p, name))


def _pick(arr: jax.Array, idx: jax.Array) -> jax.Array:
    """arr[b, idx[b]] for small trailing dims via a one-hot reduce."""
    T = arr.shape[1]
    cols = jnp.arange(T, dtype=jnp.int32)[None, :]
    # pin the accumulator dtype: under JAX x64 an int32 sum promotes to
    # int64, which corrupts downstream word-level bitcasts
    return jnp.sum(jnp.where(cols == idx[:, None], arr, 0), axis=1,
                   dtype=arr.dtype)


def _search(didx: DeviceIndex, rc_all, lengths_all, D_all, Ds_all,
            params: AlnParams, cfg: EngineConfig,
            seed_L, seed_U, seed_cnt, lanes_B: int | None):
    """Shared implementation.  When lanes_B is None, one lane per read (fixed
    batch).  Otherwise lanes_B lanes stream through all NR reads (queue
    mode): outputs land in [NR, ...] slabs."""
    NR, Lmax = rc_all.shape
    QUEUED = lanes_B is not None
    B = lanes_B if QUEUED else NR
    ACAP, KX, FL = cfg.acap, cfg.kx, cfg.flush
    IDT = didx.idt                     # interval/position dtype (i32 / i64)
    X64 = IDT == jnp.int64
    if QUEUED and X64:
        raise NotImplementedError(
            "queue mode packs node words through int32 slabs; use fixed "
            "batching (queued=False) with an int64 index")
    # node payload: L, U (1 or 2 words each) + meta1 + meta2
    NW = 6 if X64 else 4
    PATHCAP = cfg.pathcap or (Lmax + 32)
    rc_all = rc_all.astype(jnp.int32)
    lengths_all = lengths_all.astype(jnp.int32)

    p_mm = _int(params, "mm_score")
    p_go = _int(params, "gapo_score")
    p_ge = _int(params, "gape_score")
    p_maxdiff = _int(params, "max_diff")
    p_maxgapo = _int(params, "max_gapo")
    p_maxgape = _int(params, "max_gape")
    p_seedlen = _int(params, "seed_length")
    p_maxdiffseed = _int(params, "max_diff_seed")
    p_maxbest = _int(params, "max_best")
    p_noindel = _int(params, "no_indel_length")
    p_maxentries = _int(params, "max_entries")
    multiref = bool(params.is_multiref)
    # packing limits (meta1 layout); reads are capped at 255 upstream (Q5)
    assert p_maxdiff + 1 <= 31 and p_maxgapo + 1 <= 7 and p_maxgape + 1 <= 15
    assert Lmax <= 255 and PATHCAP <= 511

    if multiref:
        chars = [j for j in range(1, 16) if j not in C.SKIPPED_ORDERS]
    else:
        chars = [1, 2, 3, 4]
    NC = len(chars)
    NSLOT = 1 + 2 * NC
    HAS_SEEDS = seed_cnt is not None
    NROOT = 1 if not HAS_SEEDS else seed_L.shape[1]
    PK = _int(params, "precalc_len") if HAS_SEEDS else 0
    CAP = int(cfg.cap)
    # the last frame is a trash slab: overflow iterations write there (with
    # nothing linked) instead of clobbering live rows via clamped offsets
    assert (CAP - NROOT) // NSLOT >= 2, \
        f"cfg.cap={CAP} too small: need >= {NROOT + 2 * NSLOT} rows"
    NFRAME = (CAP - NROOT) // NSLOT - 1
    # Queue mode treats each lane's arena column as a RING over a PER-LANE
    # pop clock `pf`: lane b's pushes at its pf-th pop land in slot
    # pf % NFRAME of its own column, node ids are NROOT + pf*NSLOT + s
    # (monotonic per lane), and start_f records the lane's pf when its
    # current read started.  A read's frame budget is therefore NFRAME of
    # ITS OWN pops — a pure per-read quantity — so (a) results are
    # assignment-invariant (overflow <=> the read needs > NFRAME pops),
    # and (b) waves a lane spends in exact-completion scans or emission
    # cost it no budget and clobber none of its history.  (Round 3/4
    # counted GLOBAL any-pop waves instead: a read inside a long chunked
    # exact completion lost its arena history after NFRAME global waves,
    # which made ring mode lose to fixed batches on exact-heavy worlds.)
    # Safety: a lane is flagged overflow once its age
    # (own pops) reaches NFRAME, right before its oldest frame could be
    # reused; finished lanes' frames stay intact until refill because a
    # finished lane's pf is frozen.
    RING = QUEUED
    if RING:
        # prev links pack as (node+1) << 8 into meta2's upper 24 bits
        # (the decode masks, so the sign bit is usable): node ids must
        # fit 24 bits, which bounds per-lane pops per launch
        assert NROOT + (int(cfg.max_iters) + 2) * NSLOT < (1 << 24), \
            "ring mode: cfg.max_iters too large for packed prev links"
    ROWW = 256 if X64 else 128         # frame-row width (NSLOT*NW+1 padded)
    assert NSLOT * NW + 1 <= ROWW
    NB = ((p_maxdiff + 1) * p_mm + (p_maxgapo + 1) * p_go
          + (p_maxgape + 1) * p_ge)     # score bucket count (heap_init)
    worst = NB

    def score_of(mm, go, ge):
        return mm * p_mm + go * p_go + ge * p_ge

    col_b = jnp.arange(NB, dtype=jnp.int32)[None, :]        # bucket columns
    col_a = jnp.arange(ACAP, dtype=jnp.int32)[None, :]      # aln columns
    zi = jnp.zeros((B,), jnp.int32)
    zv = jnp.zeros((B,), IDT)
    zb = jnp.zeros((B,), bool)

    def _pack_nodes(L, U, m1, m2):
        """[B, S] node fields -> [B, S, NW] int32 words (L/U bitcast-split
        into lo/hi pairs in int64 mode)."""
        if X64:
            return jnp.concatenate(
                [jax.lax.bitcast_convert_type(L, jnp.int32),
                 jax.lax.bitcast_convert_type(U, jnp.int32),
                 m1[..., None], m2[..., None]], axis=2)
        return jnp.stack([L, U, m1, m2], axis=2)

    def _unpack_nodes(v):
        """[B, NW] int32 words -> (L, U, m1, m2)."""
        if X64:
            L = jax.lax.bitcast_convert_type(v[:, 0:2], jnp.int64)
            U = jax.lax.bitcast_convert_type(v[:, 2:4], jnp.int64)
            return L, U, v[:, 4], v[:, 5]
        return v[:, 0], v[:, 1], v[:, 2], v[:, 3]

    lane_iota = jnp.arange(B, dtype=jnp.int32)

    def _node_read4(st_, node):
        """(L, U, m1, m2) of a node per lane: one 512-byte frame-ROW gather
        plus a dense slot select; ids < NROOT come from the packed root
        rows."""
        nn = jnp.maximum(node - NROOT, 0)
        f = nn // NSLOT
        s = nn - f * NSLOT
        if RING:
            f = f % NFRAME
        flat = st_["aN"].reshape(NAREN * B, ROWW)
        rowv = jnp.take(flat, f * B + lane_iota, axis=0)      # [B, ROWW]
        slots = rowv[:, :NSLOT * NW].reshape(B, NSLOT, NW)
        sl1h = jnp.arange(NSLOT, dtype=jnp.int32)[None, :] == s[:, None]
        aV = jnp.sum(jnp.where(sl1h[:, :, None], slots, 0), axis=1,
                     dtype=jnp.int32)                                # [B, NW]
        if NROOT == 1:
            rV = st_["rtN"][:, 0]
        else:
            rV = jnp.take_along_axis(
                st_["rtN"], jnp.clip(node, 0, NROOT - 1)[:, None, None],
                1)[:, 0]
        return _unpack_nodes(jnp.where((node < NROOT)[:, None], rV, aV))

    # ---------------------------------------------------- per-read init logic

    def read_init(rc, lengths, sL, sU, scnt):
        """Root-node rows (NROOT per lane), initial heads, open counts, and
        the up-front N-count discard (inexact_match.c:259-266)."""
        if not HAS_SEEDS:
            rL = jnp.zeros((B, NROOT), IDT)
            rU = jnp.full((B, NROOT), didx.length - 1, IDT)
            rM1 = _pack1(lengths, 0, 0, 0, C.STATE_M, 0)[:, None]
            rM2 = jnp.zeros((B, NROOT), jnp.int32)
            head0 = jnp.full((B, NB), -1, jnp.int32).at[:, 0].set(0)
            n_open = jnp.ones((B,), jnp.int32)
            no_seed_hit = zb
        else:
            slot = jnp.arange(NROOT, dtype=jnp.int32)[None, :]
            live = slot < scnt[:, None]
            rL = jnp.where(live, sL.astype(IDT), 0)
            rU = jnp.where(live, sU.astype(IDT), -1)
            rM1 = jnp.where(live, _pack1((lengths - PK)[:, None], 0, 0, 0,
                                         C.STATE_M, PK), 0)
            # LIFO chain within bucket 0: slot s links to s-1
            rM2 = jnp.where(live, slot << 8, 0)
            head0 = jnp.full((B, NB), -1, jnp.int32).at[:, 0].set(
                jnp.where(scnt > 0, scnt - 1, -1))
            n_open = scnt.astype(jnp.int32)
            no_seed_hit = scnt == 0
        pos = jnp.arange(Lmax, dtype=jnp.int32)[None, :]
        n_count = jnp.sum((rc > 3) & (pos < lengths[:, None]), axis=1)
        discard = (n_count > p_maxdiff) | no_seed_hit
        rtN = _pack_nodes(rL, rU, jnp.broadcast_to(rM1, rL.shape),
                          jnp.broadcast_to(rM2, rL.shape))
        return rtN, head0, n_open, discard

    # ---------------------------------------------------------- initial state
    first = jnp.arange(B, dtype=jnp.int32) % NR   # queue: first B reads
    if QUEUED:
        rc0 = rc_all[first]
        len0 = lengths_all[first]
        D0 = D_all[first]
        Ds0 = Ds_all[first]
        sL0 = seed_L[first] if HAS_SEEDS else None
        sU0 = seed_U[first] if HAS_SEEDS else None
        scnt0 = seed_cnt[first] if HAS_SEEDS else None
    else:
        rc0, len0, D0, Ds0 = rc_all, lengths_all, D_all, Ds_all
        sL0, sU0, scnt0 = seed_L, seed_U, seed_cnt

    rtN0, head0, n_open0, discard0 = read_init(rc0, len0, sL0, sU0, scnt0)

    # root rows (node ids < NROOT) live in small dedicated arrays so queue-
    # mode read switches never scatter into the big arena planes (which
    # would break XLA's in-place aliasing of the loop carry)
    # Node values live in frame rows: aN[f, b, 4s..4s+3] is slot s of frame
    # f on lane b; col NSLOT*4 holds the frame's parent node id.  A pop is
    # then one row gather on the [F*B, 128] view; a frame write is one
    # contiguous [1, B, 128] update slice.  Ring mode needs no trash row
    # (writes always land in range).
    NAREN = NFRAME if RING else NFRAME + 1
    aN = jnp.zeros((NAREN, B, ROWW), jnp.int32)

    state = dict(
        aN=aN, head=head0,
        rtN=rtN0,
        rc=rc0, len=len0, D=D0, Ds=Ds0,
        cur=first,                     # read id being processed per lane
        n_pushed=jnp.full((B,), NROOT, jnp.int32),
        n_open=jnp.where(discard0, 0, n_open0),
        mode=jnp.where(discard0 | (jnp.arange(B) >= NR), MODE_DONE,
                       MODE_DFS).astype(jnp.int32),
        best_score=jnp.full((B,), worst, jnp.int32),
        max_diff=jnp.full((B,), p_maxdiff, jnp.int32),
        num_best=zv,
        overflow=zb,
        # per-lane alignment scratch (flushed per read in queue mode)
        o_L=jnp.zeros((B, ACAP), IDT),
        o_U=jnp.zeros((B, ACAP), IDT),
        o_score=jnp.zeros((B, ACAP), jnp.int32),
        o_len=jnp.zeros((B, ACAP), jnp.int32),
        o_node=jnp.zeros((B, ACAP), jnp.int32),
        o_m1=jnp.zeros((B, ACAP), jnp.int32),
        o_snp=jnp.zeros((B, ACAP), jnp.int32),
        n_alns=zi,
        # exact-completion scan
        x_L=jnp.zeros((B, KX), IDT),
        x_U=jnp.full((B, KX), -1, IDT),
        x_cnt=zi,
        x_j=zi,
        x_node=zi,
        x_m1=zi,
        x_m2=zi,
        iters=jnp.int32(0),
        fcnt=jnp.int32(0),      # frames consumed
    )
    if QUEUED:
        state.update(
            counter=jnp.int32(min(B, NR)),
            # lanes beyond NR (duplicate initial reads) stay permanently idle
            flushed=jnp.arange(B) >= NR,
            # per-lane pop clock (ring frame slots / node ids / age)
            pf=jnp.zeros((B,), jnp.int32),
            # ring clock: the lane's pf when its current read started
            start_f=jnp.zeros((B,), jnp.int32),
            # packed per-read result slabs:
            #   q_alns[r] = [L, U, score, len, node, m1, snp] x ACAP
            #   q_meta[r] = [n_alns, overflow, lane]; n_alns -1 = incomplete
            #   q_paths[r] = reverse-order state walks (filled at flush,
            #   BEFORE the ring reuses the read's frame rows)
            q_alns=jnp.zeros((NR, 7, ACAP), jnp.int32),
            q_meta=jnp.zeros((NR, 3), jnp.int32).at[:, 0].set(-1),
            q_paths=jnp.zeros((NR, ACAP, PATHCAP), jnp.int8),
        )

    if HAS_SEEDS and QUEUED:
        state.update(sL=sL0.astype(jnp.int32), sU=sU0.astype(jnp.int32),
                     scnt=scnt0.astype(jnp.int32))

    # ------------------------------------------------------------- emissions

    def emit_alns(st_, lanes, node, m1, m2, Ls, Us, cnt, extra_m):
        """Record alignments for `lanes`: intervals (Ls,Us)[:cnt] in slot
        order, path length = node.plen + extra_m; m1/m2 are the node's meta
        words (callers hold them — no re-gather).  Implements the hit /
        exact-completion bookkeeping of inexact_match.c:331-375 and
        add_alignment's gap dedup (align.c:271-298)."""
        _i, mm, go, ge, _st, plen = _unpack1(m1)
        snp = m2 & 0xFF
        score = score_of(mm, go, ge)

        first_hit = lanes & (st_["n_alns"] == 0)
        best_diff = mm + go + ge
        new_best = jnp.minimum(best_diff + 1, p_maxdiff)
        best_score = jnp.where(first_hit, score, st_["best_score"])
        max_diff = jnp.where(first_hit, new_best, st_["max_diff"])

        width = jnp.sum(jnp.where(
            jnp.arange(Ls.shape[1], dtype=jnp.int32)[None, :] < cnt[:, None],
            Us - Ls + 1, 0), axis=1, dtype=IDT)
        is_best = score == best_score
        num_best = st_["num_best"] + jnp.where(lanes & is_best, width, 0)
        # suboptimal hit with enough best hits already => stop this read
        stop = lanes & ~is_best & (st_["num_best"] > p_maxbest)

        o_L, o_U = st_["o_L"], st_["o_U"]
        o_score, o_len = st_["o_score"], st_["o_len"]
        o_node, n_alns = st_["o_node"], st_["n_alns"]
        o_m1, o_snp = st_["o_m1"], st_["o_snp"]
        over = st_["overflow"]
        add_len = plen + extra_m
        for s in range(Ls.shape[1]):
            Lv, Uv = Ls[:, s], Us[:, s]
            ok = lanes & ~stop & (s < cnt)
            dup = jnp.any((o_L == Lv[:, None]) & (o_U == Uv[:, None])
                          & (col_a < n_alns[:, None]), axis=1)
            ok = ok & ~(dup & (go > 0))
            full = ok & (n_alns >= ACAP)
            ok = ok & ~full
            over = over | full
            sel = ok[:, None] & (col_a == n_alns[:, None])
            o_L = jnp.where(sel, Lv[:, None], o_L)
            o_U = jnp.where(sel, Uv[:, None], o_U)
            o_score = jnp.where(sel, score[:, None], o_score)
            o_len = jnp.where(sel, add_len[:, None], o_len)
            o_node = jnp.where(sel, node[:, None], o_node)
            o_m1 = jnp.where(sel, m1[:, None], o_m1)
            o_snp = jnp.where(sel, snp[:, None], o_snp)
            n_alns = n_alns + ok.astype(jnp.int32)

        st_ = dict(st_)
        st_.update(best_score=best_score, max_diff=max_diff,
                   num_best=num_best, o_L=o_L, o_U=o_U, o_score=o_score,
                   o_len=o_len, o_node=o_node, o_m1=o_m1, o_snp=o_snp,
                   n_alns=n_alns, overflow=over)
        st_["mode"] = jnp.where(stop, MODE_DONE, st_["mode"])
        return st_

    # ------------------------------------------------- queue flush + refill

    def read_init_fl(rc, lengths, sL, sU, scnt):
        """read_init over FL rows (same math, smaller batch)."""
        if not HAS_SEEDS:
            rLr = jnp.zeros((FL, NROOT), jnp.int32)
            rUr = jnp.full((FL, NROOT), didx.length - 1, jnp.int32)
            rM1r = _pack1(lengths, 0, 0, 0, C.STATE_M, 0)[:, None]
            rM2r = jnp.zeros((FL, NROOT), jnp.int32)
            head0 = jnp.full((FL, NB), -1, jnp.int32).at[:, 0].set(0)
            n_open = jnp.ones((FL,), jnp.int32)
            no_seed_hit = jnp.zeros((FL,), bool)
        else:
            slot = jnp.arange(NROOT, dtype=jnp.int32)[None, :]
            live = slot < scnt[:, None]
            rLr = jnp.where(live, sL.astype(jnp.int32), 0)
            rUr = jnp.where(live, sU.astype(jnp.int32), -1)
            rM1r = jnp.where(live, _pack1((lengths - PK)[:, None], 0, 0, 0,
                                          C.STATE_M, PK), 0)
            rM2r = jnp.where(live, slot << 8, 0)
            head0 = jnp.full((FL, NB), -1, jnp.int32).at[:, 0].set(
                jnp.where(scnt > 0, scnt - 1, -1))
            n_open = scnt.astype(jnp.int32)
            no_seed_hit = scnt == 0
        pos = jnp.arange(Lmax, dtype=jnp.int32)[None, :]
        n_count = jnp.sum((rc > 3) & (pos < lengths[:, None]), axis=1)
        discard = (n_count > p_maxdiff) | no_seed_hit
        rtNr = jnp.stack([rLr, rUr, jnp.broadcast_to(rM1r, rLr.shape),
                          jnp.broadcast_to(rM2r, rLr.shape)], axis=2)
        return rtNr, head0, n_open, discard

    def _mm_exact(a_f32, v_i32):
        """Exact int32 gather/expand through float32 matmuls: a has at most
        one nonzero (1.0) per output row, so each output is a single int32
        routed via two 16-bit halves (exact in f32)."""
        v2 = v_i32.reshape(v_i32.shape[0], -1)
        hi = (v2 >> 16).astype(jnp.float32)
        lo = (v2 & 0xFFFF).astype(jnp.float32)
        # HIGHEST precision is required: a default-precision float32
        # product may run in TF32 (or bf16 passes), which would round the
        # 16-bit halves
        mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
        out = (mm(a_f32, hi).astype(jnp.int32) << 16) \
            + mm(a_f32, lo).astype(jnp.int32)
        return out.reshape((a_f32.shape[0],) + v_i32.shape[1:])

    def switch_step(st_):
        """Flush up to FL finished lanes to the per-read slabs and hand them
        the next reads from the global counter.  All lane-state updates are
        one-hot matmul expansions + selects and the flush is TWO packed
        scatters into the per-read slabs; none target per-lane state."""
        st_ = dict(st_)
        fin = (st_["mode"] == MODE_DONE) & ~st_["flushed"]
        rank = jnp.cumsum(fin.astype(jnp.int32)) - 1          # [B]
        take = fin & (rank < FL)
        # one-hot [B, FL]: lane b occupies flush slot rank[b]
        frow = jnp.arange(FL, dtype=jnp.int32)[None, :]
        oh = take[:, None] & (rank[:, None] == frow)          # [B, FL]
        oh_f = oh.astype(jnp.float32)
        nflush = jnp.sum(take, dtype=jnp.int32)
        fvalid = frow[0] < nflush                             # [FL]

        gat = lambda v: _mm_exact(oh_f.T, v)                  # [B,...]->[FL,...]
        lane_f = gat(jnp.arange(B, dtype=jnp.int32))
        rid_f = jnp.where(fvalid, gat(st_["cur"]), NR)        # drop padding

        # flush the selected lanes' outputs: two packed scatters
        fv = jnp.stack([gat(st_[k]) for k in
                        ("o_L", "o_U", "o_score", "o_len", "o_node",
                         "o_m1", "o_snp")], axis=1)           # [FL, 7, ACAP]
        st_["q_alns"] = st_["q_alns"].at[rid_f].set(fv, mode="drop")
        fm = jnp.stack([gat(st_["n_alns"]),
                        gat(st_["overflow"].astype(jnp.int32)),
                        lane_f], axis=1)                      # [FL, 3]
        st_["q_meta"] = st_["q_meta"].at[rid_f].set(fm, mode="drop")
        st_["flushed"] = st_["flushed"] | take

        # walk the flushed alignments' parent chains NOW — the ring reuses
        # these frame rows once the lane moves on (same states as
        # walk_paths; garbage rows of overflowed lanes are never read back)
        states_tbl = jnp.asarray(slot_states(NC))             # [NSLOT]
        node_f = fv[:, 4].astype(jnp.int32)
        flatA = st_["aN"].reshape(NAREN * B, ROWW)
        sl_cols = jnp.arange(NSLOT, dtype=jnp.int32)[None, None, :]

        def wstep(t, carry):
            cur, paths = carry
            nn = jnp.maximum(cur - NROOT, 0)
            f = (nn // NSLOT) % NFRAME
            rows = jnp.take(
                flatA, (f * B + lane_f[:, None]).reshape(-1),
                axis=0).reshape(FL, ACAP, ROWW)
            par = jnp.where(cur >= NROOT, rows[:, :, NSLOT * NW], -1)
            alive = (cur >= 0) & (par >= 0)
            slot = jnp.where(cur >= NROOT, nn % NSLOT, 0)
            stv = jnp.sum(jnp.where(sl_cols == slot[:, :, None],
                                    states_tbl[None, None, :], 0),
                          axis=2, dtype=jnp.int8)
            stv = jnp.where(alive, stv, 0)
            paths = jax.lax.dynamic_update_slice(
                paths, stv[:, :, None], (0, 0, t))
            return (jnp.where(alive, par, -1), paths)

        _, paths_f = jax.lax.fori_loop(
            0, PATHCAP, wstep,
            (node_f, jnp.zeros((FL, ACAP, PATHCAP), jnp.int8)))
        st_["q_paths"] = st_["q_paths"].at[rid_f].set(paths_f, mode="drop")

        # refill: flush slot f gets read counter + f (prefix of valid slots)
        new_rid = st_["counter"] + frow[0]                    # [FL]
        get_f = fvalid & (new_rid < NR)
        n_assign = jnp.sum(get_f, dtype=jnp.int32)
        safe = jnp.clip(jnp.where(get_f, new_rid, 0), 0, NR - 1)
        rc_f = rc_all[safe]                                   # [FL, Lmax]
        len_f = lengths_all[safe]
        D_f = D_all[safe]
        Ds_f = Ds_all[safe]
        sL_f = seed_L[safe].astype(jnp.int32) if HAS_SEEDS else None
        sU_f = seed_U[safe].astype(jnp.int32) if HAS_SEEDS else None
        scnt_f = seed_cnt[safe].astype(jnp.int32) if HAS_SEEDS else None
        rtNr, head0, n_open_f, discard_f = read_init_fl(
            rc_f, len_f, sL_f, sU_f, scnt_f)

        # expand the new reads back onto their lanes (one-hot matmuls +
        # selects; slots without a new read expand nowhere)
        ohg = oh & get_f[None, :]
        ohg_f = ohg.astype(jnp.float32)
        got = jnp.any(ohg, axis=1)                            # [B]
        exp = lambda vf: _mm_exact(ohg_f, vf)                 # [FL,...]->[B,...]
        sel = lambda k, vf: jnp.where(
            got.reshape((B,) + (1,) * (st_[k].ndim - 1)), exp(vf), st_[k])
        st_["rc"] = sel("rc", rc_f)
        st_["len"] = sel("len", len_f)
        st_["D"] = sel("D", D_f)
        st_["Ds"] = sel("Ds", Ds_f)
        if HAS_SEEDS:
            st_["sL"] = sel("sL", sL_f)
            st_["sU"] = sel("sU", sU_f)
            st_["scnt"] = sel("scnt", scnt_f)
        # root rows are safe to overwrite: completed chains never read root
        # VALUES (walks stop at parent -1)
        st_["rtN"] = sel("rtN", rtNr)
        st_["head"] = sel("head", head0)
        st_["cur"] = sel("cur", new_rid)
        st_["n_open"] = sel("n_open", jnp.where(discard_f, 0, n_open_f))
        st_["mode"] = sel("mode", jnp.where(discard_f, MODE_DONE,
                                            MODE_DFS).astype(jnp.int32))
        st_["best_score"] = jnp.where(got, worst, st_["best_score"])
        st_["max_diff"] = jnp.where(got, p_maxdiff, st_["max_diff"])
        st_["num_best"] = jnp.where(got, 0, st_["num_best"])
        st_["overflow"] = jnp.where(got, False, st_["overflow"])
        st_["n_alns"] = jnp.where(got, 0, st_["n_alns"])
        st_["flushed"] = st_["flushed"] & ~got
        st_["counter"] = st_["counter"] + n_assign
        # ring clock: the new read's frame budget starts at the lane's
        # current pop count
        st_["start_f"] = jnp.where(got, st_["pf"], st_["start_f"])
        return st_

    # --------------------------------------------------------- exact-scan step

    def exact_step(st_):
        rc, Lm = st_["rc"], Lmax
        lanes = st_["mode"] == MODE_EXACT
        j = st_["x_j"]
        c = jnp.where(lanes & (j >= 0), _pick(rc, jnp.clip(j, 0, Lm - 1)), 4)
        if multiref:
            nL, nU, ncnt, _w, ov = expand_step(
                didx, st_["x_L"], st_["x_U"], st_["x_cnt"], c)
        else:
            # single-interval 1-to-1 scan (exact_match_1to1_bounded)
            is_n = c > 3
            gc = jnp.asarray(_GRAY4)[jnp.clip(c, 0, 4)]
            L0, U0 = st_["x_L"][:, 0], st_["x_U"][:, 0]
            occL, occU = rank1_pair(didx, gc, L0 - 1, U0)
            Cc = jnp.take(didx.Carr, gc)
            L1 = Cc + occL + 1
            U1 = Cc + occU
            dead = is_n | (L1 > U1)
            nL = st_["x_L"].at[:, 0].set(jnp.where(dead, 0, L1).astype(IDT))
            nU = st_["x_U"].at[:, 0].set(jnp.where(dead, -1, U1).astype(IDT))
            ncnt = jnp.where(dead, 0, 1)
            ov = zb
        adv = lanes
        nL = jnp.where(adv[:, None], nL, st_["x_L"])
        nU = jnp.where(adv[:, None], nU, st_["x_U"])
        ncnt = jnp.where(adv, ncnt, st_["x_cnt"])
        nj = jnp.where(adv, j - 1, j)
        over = st_["overflow"] | (adv & ov)

        finished = adv & ((ncnt == 0) | (nj < 0))
        matched = finished & (ncnt > 0)

        st_ = dict(st_)
        st_.update(x_L=nL, x_U=nU, x_cnt=ncnt, x_j=nj, overflow=over)
        # extra matched chars: the scan consumed (e.i) chars => path extends
        # by e.i implicit matches (inexact_match.c:365)
        a_i = st_["x_m1"] & 0xFF
        st_ = emit_alns(st_, matched, st_["x_node"], st_["x_m1"],
                        st_["x_m2"], nL, nU,
                        jnp.where(matched, ncnt, 0), a_i)
        # finished lanes resume the DFS (unless emit stopped them)
        st_["mode"] = jnp.where(finished & (st_["mode"] == MODE_EXACT),
                                MODE_DFS, st_["mode"])
        return st_

    # --------------------------------------------------------------- DFS step

    def dfs_step(st_):
        rc, lengths, D, D_seed = st_["rc"], st_["len"], st_["D"], st_["Ds"]
        lanes = st_["mode"] == MODE_DFS

        drained = lanes & (st_["n_open"] == 0)
        too_many = lanes & (st_["n_open"] > p_maxentries)
        st_ = dict(st_)
        st_["mode"] = jnp.where(drained | too_many, MODE_DONE, st_["mode"])
        lanes = st_["mode"] == MODE_DFS

        # ---- pop: lowest occupied bucket, most recent push (heap_pop)
        head_ = st_["head"]
        occ = head_ >= 0
        bucket = jnp.argmax(occ, axis=1).astype(jnp.int32)
        node = jnp.where(lanes, _pick(head_, bucket), 0)
        eL, eU, m1, m2 = _node_read4(st_, node)
        ei, emm, ego, ege, est, eplen = _unpack1(m1)
        esnp = m2 & 0xFF
        prev = ((m2 >> 8) & 0xFFFFFF) - 1    # 24-bit link; mask the sign
        escore = bucket
        st_["head"] = jnp.where(
            lanes[:, None] & (col_b == bucket[:, None]), prev[:, None], head_)
        st_["n_open"] = st_["n_open"] - lanes.astype(jnp.int32)

        # ---- prune chain (inexact_match.c:309-328)
        stop = lanes & (escore > st_["best_score"] + p_mm)
        st_["mode"] = jnp.where(stop, MODE_DONE, st_["mode"])
        lanes = lanes & ~stop

        diff_left = st_["max_diff"] - emm - ego - ege
        cont = diff_left < 0
        Dnd = lambda arr, idx: _pick(
            arr[:, :, 0], jnp.clip(idx, 0, arr.shape[1] - 1))
        Dw = lambda arr, idx: _pick(
            arr[:, :, 1], jnp.clip(idx, 0, arr.shape[1] - 1))
        cont = cont | ((ei > 0) & (diff_left < Dnd(D, ei - 1)))
        dls = p_maxdiffseed - emm - ego - ege
        seed_index = ei - (lengths - p_seedlen)
        cont = cont | ((seed_index > 0) & (dls < Dnd(D_seed, seed_index - 1)))
        live = lanes & ~cont

        # ---- hit at i == 0 (inexact_match.c:332-344)
        hit = live & (ei == 0)
        st_ = emit_alns(st_, hit, node, m1, m2, eL[:, None], eU[:, None],
                        hit.astype(jnp.int32), zi)
        live = live & ~hit & (st_["mode"] == MODE_DFS)

        # ---- exact completion when the budget is exhausted (:345-375)
        to_exact = live & (diff_left == 0)
        st_["mode"] = jnp.where(to_exact, MODE_EXACT, st_["mode"])
        st_["x_node"] = jnp.where(to_exact, node, st_["x_node"])
        st_["x_m1"] = jnp.where(to_exact, m1, st_["x_m1"])
        st_["x_m2"] = jnp.where(to_exact, m2, st_["x_m2"])
        st_["x_j"] = jnp.where(to_exact, ei - 1, st_["x_j"])
        st_["x_cnt"] = jnp.where(to_exact, 1, st_["x_cnt"])
        st_["x_L"] = jnp.where(to_exact[:, None],
                               jnp.zeros((B, KX), IDT)
                               .at[:, 0].set(eL), st_["x_L"])
        st_["x_U"] = jnp.where(to_exact[:, None],
                               jnp.full((B, KX), -1, IDT)
                               .at[:, 0].set(eU), st_["x_U"])
        live = live & ~to_exact

        # ---- expansion (inexact_match.c:377-504)
        if multiref:
            Lv, Uv = rank_all_dfs_pair(didx, eL - 1, eU)
        else:
            Lv, Uv = rank_actg_dfs_pair(didx, eL - 1, eU)

        allow_diff = jnp.ones((B,), bool)
        allow_mm = jnp.ones((B,), bool)
        pm = ei - 1 > 0
        ad1 = diff_left - 1 < Dnd(D, ei - 2)
        am1 = ((Dnd(D, ei - 1) == diff_left - 1)
               & (Dnd(D, ei - 2) == diff_left - 1)
               & (Dw(D, ei - 1) == Dw(D, ei - 2)))
        allow_diff = allow_diff & ~(pm & ad1)
        allow_mm = allow_mm & ~(pm & ~ad1 & am1)
        ps = seed_index - 1 > 0
        ad2 = dls - 1 < Dnd(D_seed, seed_index - 2)
        am2 = ((Dnd(D_seed, seed_index - 1) == dls - 1)
               & (Dnd(D_seed, seed_index - 2) == dls - 1)
               & (Dw(D_seed, seed_index - 1) == Dw(D_seed, seed_index - 2)))
        allow_diff = allow_diff & ~(ps & ad2)
        allow_mm = allow_mm & ~(ps & ~ad2 & am2)

        tmp = ego + ege
        allow_indels = ~(((ei - 1) < (p_noindel + tmp))
                         | ((lengths - (ei - 1)) < (p_noindel + tmp)))
        allow_indels = allow_indels & ~((ego >= p_maxgapo)
                                        & (ege >= p_maxgape))
        allow_open = ego < p_maxgapo
        allow_extend = ege < p_maxgape

        c = jnp.clip(_pick(rc, jnp.clip(ei - 1, 0, Lmax - 1)), 0, 4)

        is_I = est == C.STATE_I
        is_M = est == C.STATE_M
        ind_ok = allow_diff & allow_indels

        candL = jnp.zeros((B, NSLOT), IDT)
        candU = jnp.zeros((B, NSLOT), IDT)
        candM1 = jnp.zeros((B, NSLOT), jnp.int32)
        candSc = jnp.zeros((B, NSLOT), jnp.int32)
        valid = jnp.zeros((B, NSLOT), bool)
        nplen = jnp.minimum(eplen + 1, PATHCAP - 1)
        path_over = live & (eplen + 1 >= PATHCAP)

        # slot 0: insertion (extend if state==I else open if state==M)
        ins_ok = ind_ok & ((is_I & allow_extend) | (is_M & allow_open))
        valid = valid.at[:, 0].set(live & ins_ok)
        candL = candL.at[:, 0].set(eL)
        candU = candU.at[:, 0].set(eU)
        go0 = ego + is_M.astype(jnp.int32)
        ge0 = ege + is_I.astype(jnp.int32)
        candM1 = candM1.at[:, 0].set(
            _pack1(ei - 1, emm, go0, ge0, C.STATE_I, nplen))
        candSc = candSc.at[:, 0].set(score_of(emm, go0, ge0))

        match_row = jnp.asarray(_MATCH)[c]     # [B, 16]
        for t, j in enumerate(chars):
            jj = j if multiref else t + 1      # rank-vector slot
            Lj, Uj = Lv[:, jj], Uv[:, jj]
            nonempty = Lj <= Uj
            # deletion: consumes a reference char, keeps i
            del_ok = (ind_ok & ~is_I & nonempty
                      & ((is_M & allow_open) | (~is_M & allow_extend)))
            s = 1 + t
            valid = valid.at[:, s].set(live & del_ok)
            candL = candL.at[:, s].set(Lj)
            candU = candU.at[:, s].set(Uj)
            god = ego + is_M.astype(jnp.int32)
            ged = ege + (~is_M).astype(jnp.int32)
            candM1 = candM1.at[:, s].set(
                _pack1(ei, emm, god, ged, C.STATE_D, nplen))
            candSc = candSc.at[:, s].set(score_of(emm, god, ged))

            # match/mismatch (or exact-only continuation when mm suppressed)
            if multiref:
                is_match = (c <= 3) & (j != C.ORDER_N) & (match_row[:, j] > 0)
                member = (c <= 3) & (match_row[:, j] > 0) & (j != C.ORDER_N)
            else:
                is_match = (c <= 3) & (c == j - 1)
                member = is_match
            mm_branch = allow_diff & allow_mm
            ok_mm = mm_branch & nonempty
            ok_ex = ~mm_branch & (c < 4) & member & nonempty
            s = 1 + NC + t
            valid = valid.at[:, s].set(live & (ok_mm | ok_ex))
            candL = candL.at[:, s].set(Lj)
            candU = candU.at[:, s].set(Uj)
            mmn = emm + jnp.where(ok_mm & ~is_match, 1, 0)
            candM1 = candM1.at[:, s].set(
                _pack1(ei - 1, mmn, ego, ege, C.STATE_M, nplen))
            candSc = candSc.at[:, s].set(score_of(mmn, ego, ege))

        # snp counts (meta2 low byte)
        candSnp = jnp.broadcast_to(esnp[:, None], (B, NSLOT))
        if multiref:
            snp_vec = np.zeros(NSLOT, dtype=np.int32)
            for t, j in enumerate(chars):
                snp_vec[1 + NC + t] = int(_IS_SNP[j])
            candSnp = (candSnp + jnp.asarray(snp_vec)[None, :]) & 0xFF

        # ---- frame write at lane-uniform offset (no scatter)
        any_pop = jnp.any(lanes)
        if RING:
            # per-lane node ids from the lane's own pop clock; the ring-age
            # check in body() replaces the launch-global frame_over
            base = (NROOT + st_["pf"] * NSLOT)[:, None]       # [B, 1]
            st_["overflow"] = st_["overflow"] | path_over
        else:
            base = NROOT + jnp.minimum(st_["fcnt"], NFRAME) * NSLOT
            frame_over = st_["fcnt"] >= NFRAME
            over_lane = (st_["overflow"] | path_over
                         | (lanes & frame_over))
            st_["overflow"] = over_lane
            st_["mode"] = jnp.where(lanes & frame_over, MODE_DONE,
                                    st_["mode"])
            valid = valid & ~frame_over

        # link candidates into bucket stacks, vectorized over slots:
        # prev(s) = most recent prior valid slot in the same bucket, else the
        # old bucket head; new head(v) = last valid slot with bucket v.
        # (Equivalent to pushing slots 0..NSLOT-1 sequentially — LIFO order.)
        head2 = st_["head"]
        total = jnp.sum(valid, axis=1, dtype=jnp.int32)
        bsel = jnp.clip(candSc, 0, NB - 1)                    # [B, NSLOT]
        sl = jnp.arange(NSLOT, dtype=jnp.int32)
        same = (bsel[:, :, None] == bsel[:, None, :])         # [B, s, s']
        prior = same & valid[:, None, :] & (sl[None, :] < sl[:, None])[None]
        lastp = jnp.max(jnp.where(prior, sl[None, None, :] + 1, 0),
                        axis=2) - 1                           # [B, NSLOT]
        old_head = jnp.sum(
            jnp.where(bsel[:, :, None] == col_b[:, None, :],
                      head2[:, None, :], 0), axis=2,
            dtype=jnp.int32)                                  # [B, NSLOT]
        prevs = jnp.where(lastp >= 0, base + lastp, old_head)
        sel_vb = valid[:, :, None] & (bsel[:, :, None] == col_b[:, None, :])
        lasts = jnp.max(jnp.where(sel_vb, sl[None, :, None] + 1, 0),
                        axis=1) - 1                           # [B, NB]
        st_["head"] = jnp.where(lasts >= 0, base + lasts, head2)
        candM2 = candSnp | ((prevs + 1) << 8)
        # invalid slots still occupy rows; they are simply never linked
        candN = _pack_nodes(candL, candU, candM1,
                            candM2).reshape(B, NSLOT * NW)
        frow = jnp.concatenate(
            [candN, node[:, None],
             jnp.zeros((B, ROWW - 1 - NSLOT * NW), jnp.int32)], axis=1)
        if RING:
            # per-lane ring slots: lane b's row goes to slot pf[b] % NFRAME
            # of its own column — and ONLY popped lanes write.  A garbage
            # write for a non-popping lane would be safe while age <
            # NFRAME (slot pf % NFRAME holds a dead frame of a previous
            # read), but an overflow lane frozen at age == NFRAME has live
            # frames spanning the whole ring, and a garbage write at
            # pf % NFRAME == start_f % NFRAME would clobber its OLDEST
            # live frame before the flush walk reads the chain.
            wslot_b = st_["pf"] % NFRAME
            cur_rows = st_["aN"][wslot_b, lane_iota]
            frow_m = jnp.where(lanes[:, None], frow, cur_rows)
            st_["aN"] = st_["aN"].at[wslot_b, lane_iota].set(frow_m)
            st_["pf"] = st_["pf"] + lanes.astype(jnp.int32)
        else:
            wslot = jnp.minimum(st_["fcnt"], NFRAME)
            st_["aN"] = jax.lax.dynamic_update_slice(
                st_["aN"], frow[None], (wslot, jnp.int32(0), jnp.int32(0)))
        st_["fcnt"] = st_["fcnt"] + any_pop.astype(jnp.int32)
        st_["n_pushed"] = st_["n_pushed"] + total
        st_["n_open"] = st_["n_open"] + total
        return st_

    # ------------------------------------------------------------- main loop

    def cond(st_):
        alive = jnp.any(st_["mode"] != MODE_DONE)
        if QUEUED:
            alive = alive | (st_["counter"] < NR) \
                | jnp.any((st_["mode"] == MODE_DONE) & ~st_["flushed"]
                          & (jnp.arange(B) < NR))
        return alive & (st_["iters"] < cfg.max_iters)

    def body(st_):
        if QUEUED:
            # ring budget: a read that has made NFRAME pops is about to
            # lose its oldest frame row — flag it overflow (host fallback)
            # before any stale row could be read.  Age is the lane's OWN
            # pop count since refill, so the budget is per-read exact.
            age = st_["pf"] - st_["start_f"]
            ring_over = (st_["mode"] != MODE_DONE) & (age >= NFRAME)
            st_ = dict(st_)
            st_["overflow"] = st_["overflow"] | ring_over
            st_["mode"] = jnp.where(ring_over, MODE_DONE, st_["mode"])
            fin = (st_["mode"] == MODE_DONE) & ~st_["flushed"]
            nfin = jnp.sum(fin, dtype=jnp.int32)
            # flush/refill is the loop's most expensive branch: amortize it
            # over >= GATE finished lanes mid-run, but drain promptly once
            # the queue is empty or no lane has live work.  Lane<->read
            # assignment changes with the gate; per-read results don't.
            # Finished lanes nearing the ring boundary force a flush (their
            # chains must be walked before their rows are reused); the
            # B//FL slack covers the worst case of every lane finishing at
            # once with flushes capped at FL lanes per iteration.
            drain = ((st_["counter"] >= NR)
                     | ~jnp.any(st_["mode"] != MODE_DONE))
            urg = max(2, NFRAME - (B // FL) - 2)
            urgent = jnp.any(fin & (age >= urg))
            # gate at FL finished lanes (full flush batches): with the
            # per-lane pop clock a finished lane's frames are frozen until
            # refill, so waiting costs only idle lanes.  cfg.flush is
            # therefore the switch-amortization knob.
            do_sw = (nfin >= FL) | ((nfin > 0) & drain) | urgent
            st_ = jax.lax.cond(do_sw, switch_step, lambda s: dict(s), st_)
        any_exact = jnp.any(st_["mode"] == MODE_EXACT)

        def exact_steps(s):
            # advance exact-completion scans several chars per global
            # iteration: per-read scans stay sequential (parity-safe), but
            # the loop's fixed costs amortize over XS chars
            for _ in range(max(1, int(cfg.xsteps))):
                s = exact_step(s)
            return s

        st_ = jax.lax.cond(any_exact, exact_steps, lambda s: dict(s), st_)
        st_ = dfs_step(st_)
        st_ = dict(st_)
        st_["iters"] = st_["iters"] + 1
        return st_

    st = jax.lax.while_loop(cond, body, state)
    timeout = st["mode"] != MODE_DONE

    if QUEUED:
        # reads never flushed (loop cap hit) stay n_alns == -1 -> fallback
        qa, qm = st["q_alns"], st["q_meta"]
        m1o = qa[:, 5]
        return dict(
            n_alns=jnp.maximum(qm[:, 0], 0),
            o_L=qa[:, 0], o_U=qa[:, 1], o_score=qa[:, 2],
            o_len=qa[:, 3], o_node=qa[:, 4], o_lane=qm[:, 2],
            o_mm=(m1o >> _SH_MM) & 0x1F,
            o_go=(m1o >> _SH_GO) & 0x7,
            o_ge=(m1o >> _SH_GE) & 0xF,
            o_snp=qa[:, 6],
            o_plen=(m1o >> _SH_PLEN) & 0x1FF,
            overflow=(qm[:, 1] > 0) | (qm[:, 0] < 0),
            iters=st["iters"],
            n_pushed=st["n_pushed"],
            # reverse-order state walks, filled at flush time (the ring
            # arena reuses frame rows, so no post-loop walk is possible).
            # 2-bit packed (states are M/I/D) — paths dominate the
            # device->host result volume; see unpack_paths
            paths=pack_paths(st["q_paths"]),
        )

    m1o = st["o_m1"]
    return dict(
        n_alns=st["n_alns"],
        o_L=st["o_L"], o_U=st["o_U"], o_score=st["o_score"],
        o_len=st["o_len"],
        o_node=st["o_node"],
        o_mm=(m1o >> _SH_MM) & 0x1F,
        o_go=(m1o >> _SH_GO) & 0x7,
        o_ge=(m1o >> _SH_GE) & 0xF,
        o_snp=st["o_snp"],
        o_plen=(m1o >> _SH_PLEN) & 0x1FF,
        overflow=st["overflow"] | timeout,
        iters=st["iters"],
        n_pushed=st["n_pushed"],
        # frame rows stay device-resident; paths of reported alignments are
        # reconstructed afterwards over a host-compacted node list
        # (walk_paths) — states derive statically from a node's frame slot.
        arena=st["aN"],
    )


@partial(jax.jit, static_argnames=("params", "cfg"))
def inexact_search(didx: DeviceIndex, rc: jax.Array, lengths: jax.Array,
                   D: jax.Array, D_seed: jax.Array,
                   params: AlnParams, cfg: EngineConfig,
                   seed_L: jax.Array | None = None,
                   seed_U: jax.Array | None = None,
                   seed_cnt: jax.Array | None = None):
    """Fixed-batch search: one lane per read.

    Args:
      rc:        int32 [B, Lmax] nt4 reverse-complement reads (the search
                 operates on the RC, inexact_match.c:59-65).
      lengths:   int32 [B].
      D, D_seed: int32 [B, *, 2] lower bounds from engine.dbound.
      seed_*:    optional precalc SA intervals per lane ([B, S] plus count);
                 when given, lanes start from those entries with a PK-long
                 all-match path (inexact_match.c:269-282).
    """
    return _search(didx, rc, lengths, D, D_seed, params, cfg,
                   seed_L, seed_U, seed_cnt, lanes_B=None)


@partial(jax.jit, static_argnames=("params", "cfg", "lanes"))
def inexact_search_queued(didx: DeviceIndex, rc_all, lengths_all,
                          D_all, Ds_all, params: AlnParams,
                          cfg: EngineConfig, lanes: int,
                          seed_L=None, seed_U=None, seed_cnt=None):
    """Continuous-batching search: `lanes` lanes stream through all NR reads
    (global work queue); outputs are per-read [NR, ...] slabs plus o_lane
    (which lane's arena holds each read's parent chains)."""
    return _search(didx, rc_all, lengths_all, D_all, Ds_all, params, cfg,
                   seed_L, seed_U, seed_cnt, lanes_B=int(lanes))


def slot_states(nc: int) -> np.ndarray:
    """State appended by each candidate slot: [I, D*nc, M*nc]."""
    return np.array([C.STATE_I] + [C.STATE_D] * nc + [C.STATE_M] * nc,
                    dtype=np.int8)


def pack_paths(paths: jax.Array) -> jax.Array:
    """[..., PC] int8 state walks (values 0..3) -> [..., ceil(PC/4)]
    uint8, 2 bits per state.  Queue-mode paths dominate the
    device->host result volume (NR x ACAP x PATHCAP bytes), so they
    ship packed and `unpack_paths` restores them host-side."""
    pc = paths.shape[-1]
    pad = (-pc) % 4
    if pad:
        paths = jnp.pad(paths, [(0, 0)] * (paths.ndim - 1) + [(0, pad)])
    g = paths.reshape(paths.shape[:-1] + ((pc + pad) // 4, 4))
    g = g.astype(jnp.int32)
    packed = (g[..., 0] | (g[..., 1] << 2) | (g[..., 2] << 4)
              | (g[..., 3] << 6))
    return packed.astype(jnp.uint8)


def unpack_paths(packed: np.ndarray, pathcap: int) -> np.ndarray:
    """Host-side inverse of pack_paths (vectorized numpy)."""
    out = np.zeros(packed.shape[:-1] + (packed.shape[-1] * 4,),
                   dtype=np.int8)
    for i in range(4):
        out[..., i::4] = (packed >> (2 * i)) & 3
    return out[..., :pathcap]


@partial(jax.jit, static_argnames=("nroot", "nslot", "nc", "pathcap", "nw"))
def walk_paths(arena: jax.Array, lanes: jax.Array, nodes: jax.Array,
               nroot: int, nslot: int, nc: int, pathcap: int,
               nw: int = 4) -> jax.Array:
    """Reverse-order state paths for a flat list of (lane, node) alignments.

    A node's appended state is a static function of its frame slot
    ((node - nroot) % nslot), so only the parent id — column nslot*nw of
    the node's frame row in `arena` [F, B, ROWW] — is gathered per step
    (nw = node words per slot: 4, or 6 for int64 indices).
    Returns int8 [W, pathcap]; entry t is the state of the t-th ancestor
    (the node itself first; roots contribute nothing).
    """
    W = nodes.shape[0]
    F, B, _ = arena.shape
    flat = arena.reshape(F * B, arena.shape[2])
    states = jnp.asarray(slot_states(nc))

    def step(t, carry):
        cur, paths = carry
        nn = jnp.maximum(cur - nroot, 0)
        f = jnp.clip(nn // nslot, 0, F - 1)
        rowv = jnp.take(flat, f * B + lanes, axis=0)
        par = jnp.where(cur >= nroot, rowv[:, nslot * nw], -1)
        alive = (cur >= 0) & (par >= 0)
        slot = jnp.where(cur >= nroot, nn % nslot, 0)
        stv = jnp.where(alive, states[slot], 0).astype(jnp.int8)
        paths = jax.lax.dynamic_update_slice(paths, stv[:, None], (0, t))
        return (jnp.where(alive, par, -1), paths)

    _, paths = jax.lax.fori_loop(
        0, pathcap, step, (nodes.astype(jnp.int32),
                           jnp.zeros((W, pathcap), jnp.int8)))
    return paths
