"""Batched FM-index rank kernels (XLA path).

Each function takes a vector of BWT positions and returns occurrence bounds
for a whole batch in lockstep — the data-parallel replacement for the
reference's per-call checkpoint+popcount loops (bwt.c:348-781).  The compute
shape is: gather one 16-word bit-plane row + one 16-wide int32 checkpoint row
per query, then count code matches with XNOR-AND + `population_count` as
vector bit math (the reference's nibble-XOR + 65,536-entry LUT, bwt.c:575-600, recast as
vector bit math; 64 popcounts replace a 128x16 one-hot reduction).

Two 16-char variants exist on purpose:
- `rank_all_exact`: true counts for every symbol (the per-base O() calls of
  the exact search and D computation, bwt.c:348-372);
- `rank_all_dfs`: the inexact-search semantics, where the three-base codes
  B/H/V/D get no in-block counts (quirk Q1, bwt.c:698-734) yet still see the
  checkpoint-first-char decrement (bwt.c:780), and where the i==-1 /
  i==length-1 edge paths return full counts for ALL symbols.

Returned values are fully-formed interval bounds: occ[j] = C[j] + O(j,i) + inc,
exactly what backward search consumes (L = occ_L[j], U = occ_U[j]).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from bwbble_tpu import constants as C
from bwbble_tpu.engine.device_index import BLK, DeviceIndex

_SKIP_MASK = np.zeros(16, dtype=bool)
for _j in C.SKIPPED_ORDERS:
    _SKIP_MASK[_j] = True

# bit t of code j, as [16 codes, 4 bits] int32
_CODE_BITS = np.array([[(j >> t) & 1 for t in range(4)] for j in range(16)],
                      dtype=np.int32)


def _take_rows(didx: DeviceIndex, arr: jax.Array, k: jax.Array) -> jax.Array:
    """Gather rows of a [num_blocks, W] plane by global block index.

    On a TP-sharded index each device holds a contiguous block range; rows
    outside the local range contribute zeros and one psum over the tp axis
    reconstructs the full gather (exactly one shard owns each row)."""
    if didx.tp_axis is None:
        return jnp.take(arr, k, axis=0)
    nloc = arr.shape[0]
    base = jax.lax.axis_index(didx.tp_axis).astype(jnp.int32) * nloc
    lk = k - base
    mine = (lk >= 0) & (lk < nloc)
    rows = jnp.take(arr, jnp.clip(lk, 0, nloc - 1), axis=0)
    rows = jnp.where(mine[:, None], rows, 0)
    return jax.lax.psum(rows, didx.tp_axis)


def _gather_block(didx: DeviceIndex, i: jax.Array):
    """Clamp i into the normal-path domain and fetch (bit-plane row [B,4,4],
    checkpoint row [B,16] in index dtype, in-block offset, first char) with
    ONE row gather from the fused table."""
    len_m1 = didx.length - 1
    i_c = jnp.clip(i, 0, jnp.maximum(len_m1 - 1, 0))
    k = (i_c // BLK).astype(jnp.int32)      # block ids always fit int32
    off = (i_c - k.astype(i_c.dtype) * BLK).astype(jnp.int32)
    rows = _take_rows(didx, didx.table, k)                   # [B, 32|48]
    pw = rows[:, :16].reshape(-1, 4, 4)                      # [B, bit, word]
    if didx.idt == jnp.int64:
        lo = rows[:, 16:32].astype(jnp.int64) & 0xFFFFFFFF
        ck = (rows[:, 32:48].astype(jnp.int64) << 32) | lo   # [B, 16] i64
    else:
        ck = rows[:, 16:32]                                  # [B, 16] i32
    first = ((pw[:, 0, 0] & 1) | ((pw[:, 1, 0] & 1) << 1)
             | ((pw[:, 2, 0] & 1) << 2) | ((pw[:, 3, 0] & 1) << 3))
    return pw, ck, off, first


def _prefix_masks(off: jax.Array) -> jax.Array:
    """[B, 4] word masks selecting bit positions 0..off within the block."""
    nbits = off[:, None] + 1 - 32 * jnp.arange(4, dtype=jnp.int32)[None, :]
    partial = (1 << jnp.clip(nbits, 0, 31)) - 1
    return jnp.where(nbits >= 32, -1, jnp.where(nbits <= 0, 0, partial))


def _block_counts(pw: jax.Array, off: jax.Array) -> jax.Array:
    """counts[b, j] = #positions p <= off[b] in the block with code j."""
    masks = _prefix_masks(off)                               # [B, 4]
    jb = jnp.asarray(_CODE_BITS)                             # [16, 4]
    # sel[b, j, t, w] = plane word if bit t of j is 1 else its complement
    sel = jnp.where(jb[None, :, :, None] == 1,
                    pw[:, None, :, :], ~pw[:, None, :, :])
    m = sel[:, :, 0, :] & sel[:, :, 1, :] & sel[:, :, 2, :] & sel[:, :, 3, :]
    return jnp.sum(jax.lax.population_count(m & masks[:, None, :]),
                   axis=2, dtype=jnp.int32)                  # [B, 16]


def _block_count1(pw: jax.Array, off: jax.Array, c: jax.Array) -> jax.Array:
    """counts[b] = #positions p <= off[b] with code c[b]."""
    masks = _prefix_masks(off)                               # [B, 4]
    cb = jnp.asarray(_CODE_BITS)[c]                          # [B, 4]
    sel = jnp.where(cb[:, :, None] == 1, pw, ~pw)            # [B, 4, 4]
    m = sel[:, 0, :] & sel[:, 1, :] & sel[:, 2, :] & sel[:, 3, :]
    return jnp.sum(jax.lax.population_count(m & masks),
                   axis=1, dtype=jnp.int32)                  # [B]


def _rank_all(didx: DeviceIndex, i: jax.Array, inc, dfs: bool
              ) -> jax.Array:
    """inc may be a scalar or a per-query [B] vector."""
    i = i.astype(didx.idt)
    inc = jnp.asarray(inc, didx.idt)
    if inc.ndim == 1:
        inc = inc[:, None]
    len_m1 = didx.length - 1
    pw, ck, off, first = _gather_block(didx, i)
    cnt = _block_counts(pw, off).astype(didx.idt)
    sym = jnp.arange(16, dtype=jnp.int32)
    first_dec = (first[:, None] == sym[None, :]).astype(didx.idt)
    Cv = didx.Carr[:16][None, :]

    normal = Cv + ck + cnt + inc - first_dec
    if dfs:
        skipped = Cv + inc - first_dec
        normal = jnp.where(jnp.asarray(_SKIP_MASK)[None, :], skipped, normal)
    low = Cv + inc                                # i == -1
    high = didx.Carr[1:17][None, :] + inc         # i == length-1
    out = jnp.where((i == len_m1)[:, None], high,
                    jnp.where((i < 0)[:, None], low, normal))
    return out.at[:, 0].set(0)


def rank_all_exact(didx: DeviceIndex, i: jax.Array, inc: int) -> jax.Array:
    """[B] positions -> [B, 16] bounds with true counts for all symbols."""
    return _rank_all(didx, i, inc, dfs=False)


def rank_all_dfs(didx: DeviceIndex, i: jax.Array, inc: int) -> jax.Array:
    """[B] positions -> [B, 16] bounds with inexact-search (Q1) semantics."""
    return _rank_all(didx, i, inc, dfs=True)


def rank_actg_dfs(didx: DeviceIndex, i: jax.Array, inc: int) -> jax.Array:
    """[B] -> [B, 5]; slots 1..4 = A,G,C,T bounds for single-genome mode
    (O_actg_alphabet, bwt.c:440-463).  The in-block scan is exact for the
    four pure-base symbols, so this is a projection of rank_all_exact."""
    full = _rank_all(didx, i, inc, dfs=False)
    gray = jnp.asarray(np.array(C.NT4_GRAY[:4], dtype=np.int32))
    out = jnp.zeros((i.shape[0], 5), dtype=full.dtype)
    return out.at[:, 1:5].set(jnp.take(full, gray, axis=1))


def rank1(didx: DeviceIndex, c: jax.Array, i: jax.Array) -> jax.Array:
    """Single-char rank O(c, i) per lane (bwt.c:348-372), including the
    sentinel-row exclusion for c == 0 (bwt.c:360-369)."""
    c = c.astype(jnp.int32)
    i = i.astype(didx.idt)
    len_m1 = didx.length - 1
    pw, ck, off, first = _gather_block(didx, i)
    base = (i // BLK) * BLK
    cnt = _block_count1(pw, off, c).astype(didx.idt)
    ckc = jnp.take_along_axis(ck, c[:, None], axis=1)[:, 0]
    sentinel = ((c == 0) & (base < didx.sa0) & (didx.sa0 <= i)).astype(didx.idt)
    normal = ckc + cnt - (first == c).astype(didx.idt) - sentinel
    high = (jnp.take(didx.Carr, c + 1) - jnp.take(didx.Carr, c))
    return jnp.where(i == len_m1, high,
                     jnp.where(i < 0, jnp.zeros_like(normal), normal))


def rank_all_dfs_pair(didx: DeviceIndex, iL: jax.Array, iU: jax.Array):
    """Fused (O_alphabet(L-1)+1, O_alphabet(U)) pair: one gather of 2B rows
    instead of two B-row calls (the two calls of inexact_match.c:379-385)."""
    B = iL.shape[0]
    inc = jnp.concatenate([jnp.ones((B,), didx.idt),
                           jnp.zeros((B,), didx.idt)])
    out = _rank_all(didx, jnp.concatenate([iL, iU]), inc, dfs=True)
    return out[:B], out[B:]


def rank_all_exact_pair(didx: DeviceIndex, iL: jax.Array, iU: jax.Array):
    """Fused exact-variant pair (bounds at L-1 with +1, at U with +0)."""
    B = iL.shape[0]
    inc = jnp.concatenate([jnp.ones((B,), didx.idt),
                           jnp.zeros((B,), didx.idt)])
    out = _rank_all(didx, jnp.concatenate([iL, iU]), inc, dfs=False)
    return out[:B], out[B:]


def rank_actg_dfs_pair(didx: DeviceIndex, iL: jax.Array, iU: jax.Array):
    full_L, full_U = rank_all_exact_pair(didx, iL, iU)
    gray = jnp.asarray(np.array(C.NT4_GRAY[:4], dtype=np.int32))
    outL = jnp.zeros((iL.shape[0], 5), dtype=full_L.dtype)
    outU = jnp.zeros((iU.shape[0], 5), dtype=full_U.dtype)
    return (outL.at[:, 1:5].set(jnp.take(full_L, gray, axis=1)),
            outU.at[:, 1:5].set(jnp.take(full_U, gray, axis=1)))


def rank1_pair(didx: DeviceIndex, c: jax.Array, iL: jax.Array,
               iU: jax.Array):
    """Fused single-char rank at two positions per lane."""
    cc = jnp.concatenate([c, c])
    out = rank1(didx, cc, jnp.concatenate([iL, iU]))
    B = c.shape[0]
    return out[:B], out[B:]


def bwt_char(didx: DeviceIndex, i: jax.Array) -> jax.Array:
    """B(i) per lane (bwt.c:337-345); returns int32 codes."""
    i = i.astype(didx.idt)
    k = (i // BLK).astype(jnp.int32)
    off = (i - k.astype(i.dtype) * BLK).astype(jnp.int32)
    pw = _take_rows(didx, didx.table, k)[:, :16].reshape(-1, 4, 4)
    w = off // 32
    b = off - w * 32
    bits = jnp.take_along_axis(pw, w[:, None, None], axis=2)[:, :, 0]  # [B,4]
    bits = (bits >> b[:, None]) & 1
    return (bits[:, 0] | (bits[:, 1] << 1) | (bits[:, 2] << 2)
            | (bits[:, 3] << 3))


def inv_psi(didx: DeviceIndex, i: jax.Array) -> jax.Array:
    """LF step per lane (invPsi, bwt.c:311-317)."""
    c = bwt_char(didx, i)
    step = jnp.take(didx.Carr, c) + rank1(didx, c, i)
    return jnp.where(i == didx.sa0, 0, step)


def sa_resolve(didx: DeviceIndex, rows: jax.Array) -> jax.Array:
    """Batched SA lookup: walk invPsi to a sampled row (SA, bwt.c:320-329).

    Samples are stored at rows ≡ 0 (mod SA_INTERVAL), so the lockstep walk
    length is geometric with mean SA_INTERVAL; all lanes run until every one
    has parked on a sampled row.
    """
    def cond(state):
        i, _ = state
        return jnp.any(i % C.SA_INTERVAL != 0)

    def body(state):
        i, j = state
        at_sample = (i % C.SA_INTERVAL) == 0
        i2 = inv_psi(didx, i)
        return (jnp.where(at_sample, i, i2),
                jnp.where(at_sample, j, j + 1))

    i, j = jax.lax.while_loop(cond, body,
                              (rows.astype(didx.idt),
                               jnp.zeros(rows.shape, dtype=didx.idt)))
    vals = jnp.take(didx.sa_samples, (i // C.SA_INTERVAL).astype(jnp.int32))
    return (vals + j) % didx.length
