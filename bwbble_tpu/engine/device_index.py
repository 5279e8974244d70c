"""Device-resident FM-index layout.

Redesigned for batched device rank queries (not a port of the reference's
packed-word layout): the BWT lives in device memory as bit planes, one row
per OCC_INTERVAL (=128) positions, fused with that block's occurrence
checkpoints, so one row gather fetches everything a rank query needs.

Index arithmetic is dtype-parameterized (the reference is built on
bwtint_t = uint64, common.h:6):
- int32 mode (default): genomes up to 2^31 positions (fwd+RC); fused rows
  are 128 bytes (16 plane words + 16 checkpoint counts).
- int64 mode (use_int64, or automatic at length >= 2^31): checkpoint counts
  split into lo/hi int32 columns (rows widen to 192 bytes, still ONE row
  gather per rank query); C/SA/positions and all interval math run in
  int64.  Requires JAX x64 (JAX_ENABLE_X64=1); int32 stays the default.

Larger-than-device-memory references are additionally handled by
range-sharding the index across devices (see bwbble_tpu.parallel), keeping
per-shard offsets small.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from bwbble_tpu import constants as C
from bwbble_tpu.index.fmindex import FMIndex

BLK = C.OCC_INTERVAL  # 128 positions per block


@partial(jax.tree_util.register_dataclass,
         data_fields=["table", "Carr", "sa_samples", "length", "sa0"],
         meta_fields=["tp_axis"])
@dataclasses.dataclass
class DeviceIndex:
    # One fused 128-byte row per BWT block (one L2 line on current GPUs),
    # so a rank query is a single row gather; splitting planes and
    # checkpoints would double the gather count for nothing:
    #   cols 0..15  — bit planes: table[k, 4*t + w] holds bit t of the codes
    #                 at positions w*32 .. w*32+31 of block k (LSB-first).
    #                 XNOR-AND + population_count answers a 16-char rank with
    #                 64 popcounts (far less work than an int8 one-hot
    #                 scan, 0.5 B/position).
    #   cols 16..31 — occurrence-checkpoint counts for the 16 symbols
    #                  (int64 mode: low 32 bits; cols 32..47 hold the high
    #                  32 bits so a rank query is still one row gather).
    table: jax.Array       # int32 [num_blocks, 32 or 48]
    Carr: jax.Array        # int32|int64 [17] prefix counts
    sa_samples: jax.Array  # int32|int64 [num_sa] SA values every SA_INTERVAL
    length: jax.Array      # int32|int64 scalar: BWT length
    sa0: jax.Array         # int32|int64 scalar: sentinel row
    # When set (inside shard_map), `table` holds only this device's
    # contiguous block range; rank gathers mask misses and psum over this
    # mesh axis (index range-sharded across devices, rank queries
    # answered by one all-reduce).  Checkpoint counts are
    # global cumulative ranks, so shards answer directly.
    tp_axis: str | None = None

    @property
    def num_blocks(self) -> int:
        return self.table.shape[0]

    @property
    def idt(self):
        """Index arithmetic dtype (int32 fast path / int64 whole-genome)."""
        return self.Carr.dtype


def build_planes(blocks: np.ndarray) -> np.ndarray:
    """Pack int8 code blocks [NB, 128] into bit planes [NB, 16] int32.

    packbits(bitorder='little') + a <u4 view puts bit position p%32 of
    word p//32 exactly where the rank code expects it; a broadcasted
    multiply-sum formulation was orders of magnitude slower and dominated
    device-index construction."""
    nb = blocks.shape[0]
    u = blocks.view(np.uint8)
    planes = np.zeros((nb, 4, 4), dtype=np.uint32)        # [NB, bit t, word w]
    for t in range(4):
        planes[:, t, :] = np.packbits((u >> t) & 1, axis=1,
                                      bitorder="little").view("<u4")
    return planes.reshape(nb, 16).view(np.int32)


def from_fmindex(idx: FMIndex, use_int64: bool | None = None) -> DeviceIndex:
    """Device layout for an FM-index.

    use_int64: force 64-bit index arithmetic (None = automatic when the
    index exceeds int32 positions).  The reference's whole-genome
    configuration (bwtint_t = uint64, common.h:6; fwd+RC of GRCh37 is
    ~6.2e9 positions) needs this; requires JAX x64 mode.
    """
    if use_int64 is None:
        use_int64 = idx.length >= 2**31
    if use_int64 and not jax.config.jax_enable_x64:
        raise ValueError(
            "int64 index arithmetic requires JAX x64 mode "
            "(set JAX_ENABLE_X64=1 or jax.config.update('jax_enable_x64', "
            "True))")
    if not use_int64 and idx.length >= 2**31:
        raise ValueError(
            "index has >= 2^31 positions: build with use_int64=True "
            "(or range-shard it; see bwbble_tpu.parallel)")
    num_blocks = -(-idx.length // BLK)
    blocks = np.zeros((num_blocks, BLK), dtype=np.int8)
    flat = blocks.reshape(-1)
    flat[:idx.length] = idx.bwt
    planes = build_planes(blocks).view(np.int32)
    occ = idx.occ.astype(np.int64)
    if use_int64:
        table = np.concatenate(
            [planes,
             (occ & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
             (occ >> 32).astype(np.int32)], axis=1)
        idt = np.int64
    else:
        table = np.concatenate([planes, occ.astype(np.int32)], axis=1)
        idt = np.int32
    return DeviceIndex(
        table=jnp.asarray(table),
        Carr=jnp.asarray(idx.Carr.astype(idt)),
        sa_samples=jnp.asarray(idx.sa.astype(idt)),
        length=jnp.asarray(idt(idx.length)),
        sa0=jnp.asarray(idt(idx.sa0)),
    )
