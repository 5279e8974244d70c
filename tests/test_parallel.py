"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

The sharded engines must produce bit-identical results to the single-device
engines: dp only partitions the batch, and tp's psum-reconstructed rank rows
are exact (one shard owns each block).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bwbble_tpu.align.params import AlnParams
from bwbble_tpu.engine.device_index import from_fmindex
from bwbble_tpu.engine.dbound import calc_d
from bwbble_tpu.engine.inexact import EngineConfig, inexact_search
from bwbble_tpu.engine.rank import rank_all_dfs, sa_resolve
from bwbble_tpu.parallel import make_mesh, sharded_align_step, \
    sharded_inexact_search

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

CFG = EngineConfig(cap=16384, acap=16, kx=8, max_iters=50_000)


def _batch(world, n=16):
    reads = world["reads"]
    seq = jnp.asarray(reads.seq[:n].astype(np.int32))
    rc = jnp.asarray(reads.rc[:n].astype(np.int32))
    lengths = jnp.asarray(reads.lengths[:n].astype(np.int32))
    return seq, rc, lengths


def test_sharded_inexact_matches_single_device(small_world):
    didx = from_fmindex(small_world["idx"])
    seq, rc, lengths = _batch(small_world)
    params = AlnParams(max_diff=2)
    D, _ = calc_d(didx, seq, lengths, K=16)
    sl = jnp.full_like(lengths, int(params.seed_length))
    Ds, _ = calc_d(didx, seq, sl, K=16, max_len=int(params.seed_length))

    ref = inexact_search(didx, rc, lengths, D, Ds, params, CFG)
    for dp, tp in ((4, 2), (2, 4), (8, 1)):
        mesh = make_mesh(dp, tp)
        out = sharded_inexact_search(mesh, didx, rc, lengths, D, Ds,
                                     params, CFG)
        np.testing.assert_array_equal(np.asarray(out["n_alns"]),
                                      np.asarray(ref["n_alns"]))
        for k in ("o_L", "o_U", "o_score", "o_len", "o_mm", "o_go",
                  "o_ge", "o_snp", "o_plen"):
            np.testing.assert_array_equal(np.asarray(out[k]),
                                          np.asarray(ref[k]), err_msg=k)
        np.testing.assert_array_equal(np.asarray(out["overflow"]),
                                      np.asarray(ref["overflow"]))


def test_sharded_full_step_resolves_positions(small_world):
    idx = small_world["idx"]
    didx = from_fmindex(idx)
    seq, rc, lengths = _batch(small_world, n=10)  # non-multiple of dp => pad
    params = AlnParams(max_diff=2)
    mesh = make_mesh(4, 2)
    out = sharded_align_step(mesh, didx, seq, rc, lengths, params, CFG,
                             d_cap=16)
    n_alns = np.asarray(out["n_alns"])
    ref_pos = np.asarray(out["ref_pos"])
    assert n_alns.shape[0] == 10
    assert n_alns.sum() > 0
    for b in range(10):
        if n_alns[b] > 0:
            L = int(np.asarray(out["o_L"])[b, 0])
            assert ref_pos[b] == idx.SA(L)
        else:
            assert ref_pos[b] == -1


def test_tp_rank_rows_match_replicated(small_world):
    """Range-sharded rank == replicated rank for random positions."""
    from jax.sharding import PartitionSpec as P
    import dataclasses
    from bwbble_tpu.parallel.shard import pad_index_for_tp, shard_map, \
        _index_specs

    didx = from_fmindex(small_world["idx"])
    rng = np.random.default_rng(0)
    i = jnp.asarray(rng.integers(-1, int(didx.length),
                                 size=64).astype(np.int32))
    ref = rank_all_dfs(didx, i, inc=1)

    mesh = make_mesh(1, 8)
    didx_p = pad_index_for_tp(didx, 8)

    def body(didx_l, i_l):
        didx_l = dataclasses.replace(didx_l, tp_axis="tp")
        return rank_all_dfs(didx_l, i_l, inc=1)

    out = shard_map(body, mesh=mesh, in_specs=(_index_specs(), P()),
                    out_specs=P())(didx_p, i)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_mesh_product_path_aln_byte_parity(small_world, tmp_path):
    """The --mesh pipeline (align_reads_device(mesh=...)) must emit a byte-
    identical .aln to the single-device pipeline: full D bounds, DFS, path
    walk, overflow handling, and serialization."""
    from bwbble_tpu.engine.pipeline import align_reads_device
    from bwbble_tpu.formats.aln import write_aln_file

    idx = small_world["idx"]
    didx = from_fmindex(idx)
    reads = small_world["reads"]
    params = AlnParams(max_diff=2, batch_size=64)
    cfg = EngineConfig(cap=8192, acap=16, kx=8, max_iters=50_000)

    ref = align_reads_device(idx, didx, reads, params, cfg, d_cap=16)
    f_ref = tmp_path / "single.aln"
    write_aln_file(str(f_ref), ref)

    mesh = make_mesh(4, 2)
    out = align_reads_device(idx, didx, reads, params, cfg, d_cap=16,
                             mesh=mesh)
    f_mesh = tmp_path / "mesh.aln"
    write_aln_file(str(f_mesh), out)

    assert f_mesh.read_bytes() == f_ref.read_bytes()
