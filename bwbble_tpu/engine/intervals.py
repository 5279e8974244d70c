"""Lockstep SA-interval-list expansion.

The reference keeps per-read linked lists of disjoint sorted SA intervals
(sa_intv_list_t, align.c:34-46) and expands each interval by the <=7 IUPAC
symbols matching the next read base (exact_match.c:88-109).  Here a batch of
reads holds fixed-capacity interval arrays [B, K]; one expansion step is:

1. batched rank_all_exact at (L-1) and U for every slot — [B*K] queries;
2. gather the 7 candidate bounds per lane from the per-slot rank vectors;
3. vectorized order-preserving compaction + adjoining-interval merge
   (the merge semantics of add_sa_interval, align.c:93-110) via a
   segmented min/max over merge chains.

Candidate order (slot-major, base-minor) reproduces the reference's list
construction order, so compacted lists are element-for-element identical.
Capacity overflow sets a per-lane flag; the pipeline reruns those reads
through the host gold engine.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bwbble_tpu import constants as C
from bwbble_tpu.engine.device_index import DeviceIndex
from bwbble_tpu.engine.rank import rank_all_exact_pair

_NUCL = np.asarray(C.NUCL_BASES, dtype=np.int32)          # [4, 7]
_NB = C.BASES_PER_NUCLEOTIDE
# one-hot selection matrices: _NUCL_ONEHOT[c, s, x] = 1 iff NUCL_BASES[c][s]==x
_NUCL_ONEHOT = np.zeros((4, _NB, 16), dtype=np.int32)
for _c in range(4):
    for _s in range(_NB):
        _NUCL_ONEHOT[_c, _s, int(_NUCL[_c, _s])] = 1


def expand_step(didx: DeviceIndex, Ls: jax.Array, Us: jax.Array,
                cnt: jax.Array, c: jax.Array):
    """One backward-search step over interval lists.

    Args:  Ls/Us int32 [B, K]; cnt int32 [B]; c int32 [B] nt4 read base.
    Returns (newLs, newUs, newcnt, width_sum, overflow_step):
      width_sum[b] = total width of the candidate intervals (the
      num_matches accumulator of calculate_d, inexact_match.c:226);
      overflow_step[b] = merged list exceeded K.
    Lanes with c > 3 (N) produce empty lists (exact_match.c:84-86).
    """
    B, K = Ls.shape
    # dead slots (>= cnt) query block 0: their outputs are masked out below,
    # and collapsing their row gathers onto one hot row is cheaper than
    # random lookups
    slot_live = jnp.arange(K, dtype=jnp.int32)[None, :] < cnt[:, None]
    qL = jnp.where(slot_live, Ls - 1, 0).reshape(-1)
    qU = jnp.where(slot_live, Us, 0).reshape(-1)
    occL, occU = rank_all_exact_pair(didx, qL, qU)
    occL = occL.reshape(B, K, 16)
    occU = occU.reshape(B, K, 16)

    # select the 7 candidate symbols per lane: a static column gather for
    # all 4 possible bases, then a 4-way select on c (static slicing + a
    # [B,K,4,7] select; an einsum formulation lowered to a convolution).
    # cand[b,k,s] = occ[b,k,base(c[b],s)]
    c_safe = jnp.clip(c, 0, 3)
    idx = jnp.asarray(_NUCL)                                # [4, 7] static
    candL_all = occL[:, :, idx]                             # [B, K, 4, 7]
    candU_all = occU[:, :, idx]
    c1h = c_safe[:, None, None, None] == jnp.arange(4, dtype=jnp.int32)[
        None, None, :, None]
    candL = jnp.sum(jnp.where(c1h, candL_all, 0), axis=2,
                    dtype=occL.dtype)                       # [B, K, 7]
    candU = jnp.sum(jnp.where(c1h, candU_all, 0), axis=2, dtype=occU.dtype)

    slot = jnp.arange(K, dtype=jnp.int32)
    valid = ((slot[None, :, None] < cnt[:, None, None])
             & (candL <= candU) & (c[:, None, None] < 4))

    width_sum = jnp.sum(jnp.where(valid, candU - candL + 1, 0), axis=(1, 2),
                        dtype=Ls.dtype)

    newLs, newUs, newcnt, overflow = merge_compact(
        candL.reshape(B, K * _NB), candU.reshape(B, K * _NB),
        valid.reshape(B, K * _NB), K)
    return newLs, newUs, newcnt, width_sum, overflow


def merge_compact(candL: jax.Array, candU: jax.Array, valid: jax.Array,
                  K: int):
    """Order-preserving compaction of valid candidates with adjoining-interval
    merge, returning at most K merged intervals per lane.

    Scatter-free: the previous valid candidate's U comes from a
    cummax-indexed gather, merge-chain heads are flagged in place, and the
    K outputs are one-hot reductions over the M candidate slots — all dense
    elementwise work.  (Whether plain scatters win on the GPU is ROADMAP
    C2.)
    """
    B, M = candL.shape
    # U of the previous valid slot: a "carry last valid value" scan
    # (associative select; log2(M) dense passes, no gather)
    def _carry(a, b):
        av, af = a
        bv, bf = b
        return (jnp.where(bf, bv, av), af | bf)

    lastU, _ = jax.lax.associative_scan(
        _carry, (jnp.where(valid, candU, -2), valid), axis=1)
    prevU = jnp.concatenate(
        [jnp.full((B, 1), -2, candU.dtype), lastU[:, :-1]], axis=1)
    head = valid & (candL != prevU + 1)
    gid = jnp.cumsum(head.astype(jnp.int32), axis=1) - 1
    newcnt = jnp.max(jnp.where(valid, gid + 1, 0), axis=1)

    # one-hot reduction over merge chains ([B, K, M] — candidate axis last so
    # the K outputs stay in well-tiled lanes): L of the chain head, max U
    g = jnp.arange(K, dtype=jnp.int32)[None, :, None]
    is_g = gid[:, None, :] == g                               # [B, K, M]
    Lmin = jnp.sum(jnp.where(is_g & head[:, None, :], candL[:, None, :], 0),
                   axis=2, dtype=candL.dtype)
    Umax = jnp.max(jnp.where(is_g & valid[:, None, :], candU[:, None, :], -1),
                   axis=2)

    overflow = newcnt > K
    newcnt = jnp.minimum(newcnt, K)
    live = jnp.arange(K, dtype=jnp.int32)[None, :] < newcnt[:, None]
    newLs = jnp.where(live, Lmin, 0)
    newUs = jnp.where(live, Umax, -1)
    return newLs, newUs, newcnt, overflow
