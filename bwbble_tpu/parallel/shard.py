"""Multi-device execution: DP over reads x TP over the index, via shard_map.

The reference scales with OpenMP threads over a shared read-only index on one
node (align_reads_inexact_parallel, inexact_match.c:92-168).  Here the
devices of a `jax.sharding.Mesh` replace the threads:

- **dp axis** — reads are data-parallel: each device runs the lockstep
  engines on its own read shard.  No communication at all on this axis
  (matching the reference's embarrassingly-parallel structure).
- **tp axis** — the FM-index is range-sharded: each device holds a
  contiguous range of BWT blocks + occ checkpoints (checkpoints store
  *global* ranks, so any shard answers its own positions directly).  A rank
  query gathers from exactly one shard; misses contribute zeros and one
  `psum` over tp reconstructs the row on every device
  (engine.rank._take_rows): search state replicated along tp, index
  sharded, one all-reduce per rank round.

The mesh is a plain reshape of the device list: every device of a host
reaches every other at the same rate, so no topology is assumed.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from bwbble_tpu.align.params import AlnParams
from bwbble_tpu.engine.device_index import DeviceIndex
from bwbble_tpu.engine.inexact import (EngineConfig, inexact_search,
                                       pack_paths, walk_paths)
from bwbble_tpu.engine.dbound import calc_d, calc_d_1to1
from bwbble_tpu.engine.rank import sa_resolve


def shard_map(f, *, mesh, in_specs, out_specs):
    # Replication checking is disabled: outputs are value-replicated along tp
    # by construction (every tp member holds identical post-psum state), which
    # the static checker cannot prove.
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def make_mesh(dp: int, tp: int = 1, devices=None) -> Mesh:
    """A (dp, tp) device mesh; dp*tp must not exceed available devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if dp * tp > devices.size:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} devices, "
                         f"have {devices.size}")
    return Mesh(devices[:dp * tp].reshape(dp, tp), axis_names=("dp", "tp"))


def pad_index_for_tp(didx: DeviceIndex, tp: int) -> DeviceIndex:
    """Pad the block planes so num_blocks % tp == 0.

    Padding rows are never gathered (positions are clamped to length-1
    before block lookup), so zero-fill is safe.
    """
    nb = didx.table.shape[0]
    pad = (-nb) % tp
    if pad == 0:
        return didx
    table = jnp.concatenate(
        [didx.table, jnp.zeros((pad, didx.table.shape[1]),
                               didx.table.dtype)], axis=0)
    return dataclasses.replace(didx, table=table)


def _index_specs() -> DeviceIndex:
    return DeviceIndex(table=P("tp", None), Carr=P(),
                       sa_samples=P(), length=P(), sa0=P(), tp_axis=None)


def _pad_batch(arrs, dp: int):
    """Pad batch dim to a multiple of dp; returns (padded..., valid_count)."""
    B = arrs[0].shape[0]
    pad = (-B) % dp
    if pad == 0:
        return arrs, B
    out = []
    for a in arrs:
        out.append(jnp.concatenate(
            [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], axis=0))
    return tuple(out), B


@partial(jax.jit, static_argnames=("mesh", "params", "cfg"))
def sharded_inexact_search(mesh: Mesh, didx: DeviceIndex, rc, lengths,
                           D, D_seed, params: AlnParams, cfg: EngineConfig):
    """inexact_search over a (dp, tp) mesh; same outputs, batch-sharded.

    Lanes are padded to a dp multiple with zero-length reads (which finish
    immediately); callers slice outputs back to the true batch.  In place
    of the node arena it returns `paths`: every alignment slot's state
    path, walked on the device that holds the lane's arena (a walk over
    the global arena would gather every shard's arena onto one device).
    """
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    didx = pad_index_for_tp(didx, tp)
    (rc, lengths, D, D_seed), B = _pad_batch((rc, lengths, D, D_seed), dp)

    def body(didx_l, rc_l, len_l, D_l, Ds_l):
        # tp == 1: the index is fully replicated per shard and rank
        # queries are local — dp sharding needs zero cross-device
        # communication during the search (inexact_match.c:92-168's
        # embarrassing parallelism, mapped to the mesh).  tp > 1
        # range-shards the index and routes rank queries through psum.
        didx_l = dataclasses.replace(didx_l,
                                     tp_axis="tp" if tp > 1 else None)
        out = inexact_search(didx_l, rc_l, len_l, D_l, Ds_l, params, cfg)
        out["iters"] = jnp.broadcast_to(out["iters"], rc_l.shape[:1])
        out["paths"] = _slot_paths(out, params, cfg, rc_l.shape[1],
                                   str(didx_l.idt) == "int64")
        del out["arena"]
        return out

    out_specs = dict(
        n_alns=P("dp"), o_L=P("dp", None), o_U=P("dp", None),
        o_score=P("dp", None), o_len=P("dp", None), o_node=P("dp", None),
        o_mm=P("dp", None), o_go=P("dp", None), o_ge=P("dp", None),
        o_snp=P("dp", None), o_plen=P("dp", None), overflow=P("dp"),
        iters=P("dp"), n_pushed=P("dp"), paths=P("dp", None, None))
    fn = shard_map(body, mesh=mesh,
                   in_specs=(_index_specs(), P("dp", None), P("dp"),
                             P("dp", None, None), P("dp", None, None)),
                   out_specs=out_specs)
    out = fn(didx, rc, lengths, D, D_seed)
    return {k: v[:B] for k, v in out.items()}


def _slot_paths(out, params: AlnParams, cfg: EngineConfig, lmax: int,
                x64: bool):
    """2-bit packed reverse-order state paths [B, acap, ceil(pathcap/4)]
    of every alignment slot of a fixed-batch (unseeded) result; empty
    slots walk nothing."""
    nc = 11 if params.is_multiref else 4
    B, acap = out["o_node"].shape
    pathcap = cfg.pathcap or (lmax + 32)
    live = jnp.arange(acap)[None, :] < out["n_alns"][:, None]
    nodes = jnp.where(live, out["o_node"], -1).reshape(-1)
    lanes = jnp.repeat(jnp.arange(B, dtype=jnp.int32), acap)
    paths = walk_paths(out["arena"], lanes, nodes, nroot=1,
                       nslot=1 + 2 * nc, nc=nc, pathcap=pathcap,
                       nw=6 if x64 else 4)
    return pack_paths(paths.reshape(B, acap, pathcap))


@partial(jax.jit, static_argnames=("mesh", "params", "K", "max_len"))
def sharded_calc_d_chunk(mesh: Mesh, didx: DeviceIndex, seq, lengths,
                         params: AlnParams, K: int, max_len=None):
    """The calc_d full+seed pass of one batch over a (dp, tp) mesh; exactly
    the math of pipeline._calc_d_chunk, reads sharded on dp and the index
    range-sharded on tp.  Returns (D, Ds, overflow)."""
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    didx = pad_index_for_tp(didx, tp)
    (seq, lengths), B = _pad_batch((seq, lengths), dp)
    seed_len = int(params.seed_length)

    def body(didx_l, seq_l, len_l):
        didx_l = dataclasses.replace(didx_l,
                                     tp_axis="tp" if tp > 1 else None)
        if params.is_multiref:
            D, dov1 = calc_d(didx_l, seq_l, len_l, K=K)
        else:
            D, dov1 = calc_d_1to1(didx_l, seq_l, len_l)
        use_seed = (len_l > seed_len) & (seed_len > 0)
        sl = jnp.where(use_seed, seed_len, 0).astype(jnp.int32)
        if params.is_multiref:
            Ds, dov2 = calc_d(didx_l, seq_l, sl, K=K,
                              max_len=max(seed_len, 1))
        else:
            Ds, dov2 = calc_d_1to1(didx_l, seq_l, sl,
                                   max_len=max(seed_len, 1))
        # reads not using a seed keep an all-zero D_seed (calloc semantics,
        # inexact_match.c:36,62-64)
        Ds = jnp.where(use_seed[:, None, None], Ds, 0)
        return D, Ds, dov1 | (dov2 & use_seed)

    fn = shard_map(body, mesh=mesh,
                   in_specs=(_index_specs(), P("dp", None), P("dp")),
                   out_specs=(P("dp", None, None), P("dp", None, None),
                              P("dp")))
    D, Ds, dov = fn(didx, seq, lengths)
    return D[:B], Ds[:B], dov[:B]


@partial(jax.jit, static_argnames=("mesh", "params", "cfg", "d_cap"))
def sharded_align_step(mesh: Mesh, didx: DeviceIndex, seq, rc, lengths,
                       params: AlnParams, cfg: EngineConfig,
                       d_cap: int = 32):
    """The FULL device alignment step on a (dp, tp) mesh: D bounds, seed-D
    bounds, inexact search, and SA resolution of each read's first alignment
    — everything `bwbble align` runs per batch (align_reads_inexact,
    inexact_match.c:46-66), compiled as one program over the mesh.
    """
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    didx = pad_index_for_tp(didx, tp)
    (seq, rc, lengths), B = _pad_batch((seq, rc, lengths), dp)
    seed_len = int(params.seed_length)

    def body(didx_l, seq_l, rc_l, len_l):
        didx_l = dataclasses.replace(didx_l,
                                     tp_axis="tp" if tp > 1 else None)
        if params.is_multiref:
            D, dov1 = calc_d(didx_l, seq_l, len_l, K=d_cap)
        else:
            D, dov1 = calc_d_1to1(didx_l, seq_l, len_l)
        use_seed = (len_l > seed_len) & (seed_len > 0)
        sl = jnp.where(use_seed, seed_len, 0).astype(jnp.int32)
        if params.is_multiref:
            Ds, dov2 = calc_d(didx_l, seq_l, sl, K=d_cap,
                              max_len=max(seed_len, 1))
        else:
            Ds, dov2 = calc_d_1to1(didx_l, seq_l, sl,
                                   max_len=max(seed_len, 1))
        Ds = jnp.where(use_seed[:, None, None], Ds, 0)
        out = inexact_search(didx_l, rc_l, len_l, D, Ds, params, cfg)
        out["overflow"] = out["overflow"] | dov1 | (dov2 & use_seed)
        out["iters"] = jnp.broadcast_to(out["iters"], rc_l.shape[:1])
        # resolve ref_pos of the first (best) alignment per read
        rows = jnp.where(out["n_alns"] > 0, out["o_L"][:, 0], 0)
        out["ref_pos"] = jnp.where(out["n_alns"] > 0,
                                   sa_resolve(didx_l, rows), -1)
        return out

    fn = shard_map(body, mesh=mesh,
                   in_specs=(_index_specs(), P("dp", None), P("dp", None),
                             P("dp")),
                   out_specs=P("dp"))
    out = fn(didx, seq, rc, lengths)
    return {k: v[:B] for k, v in out.items()}
