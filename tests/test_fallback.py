"""Host gold fallback under capacity overflow.

Deliberately tiny engine capacities force reads onto the gold engine
(the degradation path must be measured and parallel).
Checks: results stay byte-identical to the all-gold run, the fallback
counter reports the storm, and -t > 1 (fork pool) produces identical
results to serial fallback.
"""

import numpy as np

from bwbble_tpu.align.params import AlnParams
from bwbble_tpu.align.pipeline import align_reads_gold
from bwbble_tpu.engine.device_index import from_fmindex
from bwbble_tpu.engine.inexact import EngineConfig
from bwbble_tpu.engine.pipeline import align_reads_device, gold_fallback_many


def test_overflow_storm_matches_gold(small_world):
    idx = small_world["idx"]
    didx = from_fmindex(idx)
    reads = small_world["reads"]
    params = AlnParams(max_diff=2, batch_size=64)
    # acap=1 overflows any read with >1 recorded alignment; cap small too
    cfg = EngineConfig(cap=1024, acap=1, kx=1, max_iters=50_000)

    stats: dict = {}
    dev = align_reads_device(idx, didx, reads, params, cfg, d_cap=16,
                             stats=stats, sort_reads=False)
    gold = align_reads_gold(idx, reads, params)
    assert stats["fallback_reads"] > 0, "expected an overflow storm"
    assert dev == gold


def test_parallel_fallback_matches_serial(small_world):
    idx = small_world["idx"]
    reads = small_world["reads"]
    params = AlnParams(max_diff=2)
    sel = list(range(12))
    serial = gold_fallback_many(idx, reads, sel, params, None, n_threads=1)
    pooled = gold_fallback_many(idx, reads, sel, params, None, n_threads=3)
    assert serial == pooled
    # with a default (large) batch size the escalation ladder's deep tiers
    # (wider acap/kx) rescue the overflowing reads on-device: no gold
    # fallback, but the reads retried and results still match gold exactly
    p2 = AlnParams(max_diff=2, n_threads=4)
    didx = from_fmindex(idx)
    cfg = EngineConfig(cap=1024, acap=1, kx=1, max_iters=50_000)
    stats: dict = {}
    dev = align_reads_device(idx, didx, reads, p2, cfg, d_cap=16,
                             stats=stats, sort_reads=False, deep_tiers=True)
    gold = align_reads_gold(idx, reads, p2)
    assert stats["retried_reads"] > 0
    assert dev == gold


def test_native_calc_d_matches_gold(small_world):
    """The native unbounded-list D scanner must match gold calculate_d
    exactly (it replaces whole-read gold fallback on D overflow)."""
    import pytest
    from bwbble_tpu import constants as C
    from bwbble_tpu.gold.engine import calculate_d
    from bwbble_tpu.native import get_native

    nat = get_native()
    if nat is None or not getattr(nat, "_has_calc_d", False):
        pytest.skip("native library not built")
    idx = small_world["idx"]
    reads = small_world["reads"]
    params = AlnParams(max_diff=2)
    nb = np.ascontiguousarray(C.NUCL_BASES, dtype=np.uint8)
    planes = idx.bit_planes()
    for r in range(0, 24, 3):
        L = int(reads.lengths[r])
        gold = calculate_d(idx, reads.seq[r], L, params)
        natd = nat.calc_d_multiref(planes, idx.occ, idx.Carr, idx.length,
                                   idx.sa0, C.OCC_INTERVAL, nb,
                                   reads.seq[r], L)
        assert np.array_equal(gold, natd)


def test_gold_overlap_pool_matches_gold(small_world):
    """Overlapped gold fallback (forked worker pool running concurrently
    with the device tiers) must produce byte-identical results, with the
    overflow streamed per launch instead of drained at the end."""
    idx = small_world["idx"]
    didx = from_fmindex(idx)
    reads = small_world["reads"]
    params = AlnParams(max_diff=2, batch_size=32)
    cfg = EngineConfig(cap=1024, acap=1, kx=1, max_iters=50_000)

    stats: dict = {}
    dev = align_reads_device(idx, didx, reads, params, cfg, d_cap=16,
                             stats=stats, gold_overlap=True,
                             deep_tiers=False)
    gold = align_reads_gold(idx, reads, params)
    assert stats["fallback_reads"] > 0
    assert "t_host" in stats
    assert dev == gold


def test_streamed_scan_launch_matches_gold(tmp_path):
    """The streamed scan+launch overlap path (native D scan interleaved
    with device launches, hardest-B pending dispatch, chunked gold-pool
    routing) must stay byte-identical to the all-gold run.  Needs an
    IUPAC-dense world so the d_cap probe trips the native-scan mode."""
    from bwbble_tpu.formats.fasta import fasta2ref
    from bwbble_tpu.formats.fastq import read_fastq
    from bwbble_tpu.index import FMIndex
    from bwbble_tpu.native import get_native
    from bwbble_tpu.testutil import random_genome_fasta, simulate_reads_fastq
    import pytest

    nat = get_native()
    if nat is None or not getattr(nat, "_has_gold", False):
        pytest.skip("native gold engine unavailable")
    fa = str(tmp_path / "g.fa")
    fq = str(tmp_path / "r.fq")
    random_genome_fasta(fa, {"chr1": 400_000}, seed=21, iupac_frac=0.03)
    simulate_reads_fastq(fa, fq, 192, read_len=100, num_mm=2,
                         indel_frac=0.2, seed=22)
    codes, _ = fasta2ref(fa, str(tmp_path / "g.ref"), str(tmp_path / "g.ann"))
    idx = FMIndex.build(codes)
    reads = read_fastq(fq)
    didx = from_fmindex(idx)
    params = AlnParams(max_diff=2, batch_size=64)
    cfg = EngineConfig(cap=16384, acap=24, kx=4, max_iters=100_000)

    stats: dict = {}
    # d_cap=16: interval-list width scales with genome size, so a unit-
    # test-sized world needs a smaller cap for the probe to trip the
    # native-scan mode (the chr21 bench world trips it at 64)
    dev = align_reads_device(idx, didx, reads, params, cfg, d_cap=16,
                             stats=stats, gold_overlap=True)
    gold = align_reads_gold(idx, reads, params)
    assert stats.get("streamed"), "expected the streamed overlap path"
    assert dev == gold
