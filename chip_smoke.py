"""On-card smoke run of the aligner's main path, checked byte for byte.

Runs `bwbble index -> align -> aln2sam` through the CLI's own entry points on
one NVIDIA GPU at a realistic data size and compares every output with the
host gold engine (`--engine gold`), with zero tolerance:

  1. world   - the chr21-scale multi-genome of bench.py (46.7 Mbp genome with
               diverged repeats, synthetic VCF at 1 SNP / 100 bp and 1 indel /
               1000 bp folded in by the native data_prep + comb -w 124), the
               5 Mbp single-genome world, simulated 100 bp reads, and
               `bwbble index` on both;
  2. align   - `align -n 4` (fixed-batch ladder), `align -n 4 --queued` and
               `align -n 4 --arena 327680` on the multi-genome, each .aln
               byte-equal to `--engine gold`;
  3. aln2sam - device SA resolution, SAM byte-equal to host resolution;
  4. -S, -P  - on the 5 Mbp world, each .aln byte-equal to `--engine gold`
               (-P builds its .pre table on the device first; the gold run
               then loads that table);
  5. trace   - one traced primary search launch: time per wave, top device
               operations, device idle share of the window.

The last stdout line is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
Any failed phase raises, so the script exits non-zero without that line; it
also refuses to run (exit 2) when JAX finds no GPU.

`--four` runs only the four-card check instead: the single-card .aln of the
multi-genome (`align -n 4 --arena 327680`) against `--mesh 4`, `--mesh 2,2`
and four one-card `--dist` processes (each started with its own
CUDA_VISIBLE_DEVICES), all with the same arguments.

Usage:  python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORKDIR = os.path.join(ROOT, ".smoke")
READS = 4096          # two default batches, so the forked gold pool runs
THREADS = 8           # -t for every align run: host gold workers
sys.path.insert(0, ROOT)

import bench  # noqa: E402  (world builders)
from bwbble_tpu import cli  # noqa: E402


class SmokeError(RuntimeError):
    """A phase produced a wrong or missing result."""


# ------------------------------------------------------------------ timing

class _CompileClock:
    """Seconds JAX spent tracing, lowering and compiling, summed from its
    own monitoring events (the persistent cache makes a hit cheap)."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, name, secs, **_kw):
        if name in self.EVENTS:
            self.total += secs


_CLOCK: _CompileClock | None = None


def timed(label: str, fn, *args, **kwargs):
    """Run fn, print `label` with wall and compile seconds; returns
    (result, wall_s, compile_s)."""
    c0 = _CLOCK.total if _CLOCK else 0.0
    t0 = time.time()
    out = fn(*args, **kwargs)
    wall = time.time() - t0
    comp = (_CLOCK.total if _CLOCK else 0.0) - c0
    print(f"[{label}] wall_s={wall:.2f} compile_s={comp:.2f} "
          f"rest_s={wall - comp:.2f}", flush=True)
    return out, wall, comp


def peak_bytes(device=None) -> int:
    import jax
    device = device or jax.local_devices()[0]
    return int((device.memory_stats() or {}).get("peak_bytes_in_use", 0))


# ----------------------------------------------------------------- set-up

def check_device(expect_count: int | None = None):
    """The first JAX device, which must be a GPU; prints the card and the
    JAX set-up.  Raises SmokeError when there is no GPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SmokeError(f"no GPU: JAX's first device is {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    for line in smi.splitlines():
        print(f"card: {line}")
    print(f"jax {jax.__version__} device_kind={dev.device_kind!r} "
          f"count={len(jax.devices())}", flush=True)
    if expect_count is not None and len(jax.devices()) < expect_count:
        raise SmokeError(f"need {expect_count} GPUs, have "
                         f"{len(jax.devices())}")
    return dev


def build_native_runtime() -> None:
    """Build native/build/ from the committed sources and require the gold
    engine and the D-bound scanner: without them the main path is a
    different program, not a slower one."""
    subprocess.run([sys.executable, "-m", "bwbble_tpu.build_native"],
                   check=True, cwd=ROOT, stdout=subprocess.DEVNULL)
    from bwbble_tpu import native
    nat = native.get_native()
    if (nat is None or not getattr(nat, "_has_gold", False)
            or not getattr(nat, "_has_calc_d", False)):
        raise SmokeError("native runtime missing gold engine / D scanner")


# ----------------------------------------------------------------- phases

def make_worlds(workdir: str, n_reads: int,
                chr21_bp: int = bench.GENOME_BP,
                easy_bp: int = bench.EASY_BP) -> dict:
    """Phase 1: write both worlds' inputs and run `bwbble index` on each."""
    mgb, fq_mg = bench.write_chr21_inputs(os.path.join(workdir, "chr21"),
                                          n_reads, genome_bp=chr21_bp)
    fa_e, fq_e = bench.write_easy_inputs(os.path.join(workdir, "easy"),
                                         n_reads, genome_bp=easy_bp)
    for fa in (mgb, fa_e):
        if not os.path.exists(fa + ".bwt"):
            if cli.main(["index", fa]) != 0:
                raise SmokeError(f"bwbble index {fa} failed")
    from bwbble_tpu.index.fmindex import FMIndex
    length = FMIndex.load(mgb + ".bwt", load_sa=False).length
    print(f"world: multi-genome index {length} positions, "
          f"{n_reads} reads of {bench.READ_LEN} bp", flush=True)
    return dict(dir=workdir, mg=mgb, mg_fq=fq_mg, easy=fa_e, easy_fq=fq_e)


def align(label: str, fasta: str, fq: str, out: str, args: list[str]) -> dict:
    """One `bwbble align` run in-process; prints wall / compile seconds,
    the device engine's counters and the device's peak memory."""
    stats: dict = {}
    rc, wall, comp = timed(label, cli.cmd_align, [*args, fasta, fq, out],
                           stats=stats)
    if rc != 0:
        raise SmokeError(f"{label}: bwbble align exited {rc}")
    keys = ("t_dbounds", "t_search", "t_host", "fallback_reads",
            "retried_reads", "prerouted", "iters", "waves", "tiers")
    shown = {k: stats[k] for k in keys if k in stats}
    print(f"[{label}] counters={json.dumps(shown)} "
          f"peak_bytes_in_use={peak_bytes()}", flush=True)
    if "fallback_reads" in stats:
        from bwbble_tpu.formats.fastq import read_fastq
        n = read_fastq(fq).count
        print(f"[{label}] device-resolved reads: "
              f"{n - stats['fallback_reads']} of {n}", flush=True)
    return dict(wall_s=wall, compile_s=comp, stats=stats)


def same_bytes(label: str, got: str, want: str) -> None:
    if not filecmp.cmp(got, want, shallow=False):
        raise SmokeError(f"{label}: {os.path.basename(got)} differs from "
                         f"{os.path.basename(want)}")
    print(f"[{label}] byte-equal ({os.path.getsize(got)} bytes)", flush=True)


def _align_args(threads: int, batch: int | None) -> list[str]:
    return ["-n", "4", "-t", str(threads)] + (
        ["--batch", str(batch)] if batch else [])


def phase_multigenome(w: dict, threads: int, batch: int | None = None
                      ) -> dict:
    """Phase 2: fixed-batch and --queued device runs vs --engine gold.
    With the default arena (32,768 rows) the fixed batch's frame budget
    sends most chr21 reads to the gold pool, so a third run gives the fixed
    path a 327,680-row arena and the device most of the reads."""
    base = _align_args(threads, batch)
    d = os.path.dirname(w["mg"])
    gold = os.path.join(d, "gold.aln")
    align("mg gold", w["mg"], w["mg_fq"], gold, base + ["--engine", "gold"])
    out = {}
    for name, extra in (("fixed", []), ("queued", ["--queued"]),
                        ("fixed_arena", ["--arena", "327680"])):
        path = os.path.join(d, f"{name}.aln")
        out[name] = align(f"mg {name}", w["mg"], w["mg_fq"], path,
                          base + extra)
        same_bytes(f"mg {name} vs gold", path, gold)
    w["mg_aln"] = gold
    return out


def phase_aln2sam(w: dict) -> None:
    """Phase 3: `bwbble aln2sam` (device SA resolution) vs the host loop."""
    from bwbble_tpu.align.pipeline import alns_to_sam
    from bwbble_tpu.formats.aln import read_aln_file
    from bwbble_tpu.formats.fasta import read_ann
    from bwbble_tpu.formats.fastq import read_fastq
    from bwbble_tpu.index.fmindex import FMIndex

    sam = os.path.join(os.path.dirname(w["mg"]), "device.sam")
    rc, _, _ = timed("aln2sam device", cli.main,
                     ["aln2sam", w["mg"], w["mg_fq"], w["mg_aln"], sam])
    if rc != 0:
        raise SmokeError(f"bwbble aln2sam exited {rc}")
    idx = FMIndex.load(w["mg"] + ".bwt", load_sa=True)
    host, _, _ = timed(
        "aln2sam host", alns_to_sam, idx, read_ann(w["mg"] + ".ann"),
        read_fastq(w["mg_fq"]), read_aln_file(w["mg_aln"]),
        sa_resolver=None)
    with open(sam) as f:
        if f.read() != host:
            raise SmokeError("device-resolved SAM differs from host SAM")
    print(f"[aln2sam] device SAM byte-equal to host SAM "
          f"({len(host)} bytes)", flush=True)


def phase_single_and_precalc(w: dict, threads: int, batch: int | None = None,
                             modes: tuple[str, ...] = ("-S", "-P")) -> None:
    """Phase 4: -S and -P device runs vs --engine gold on the 5 Mbp world.
    The -P device run builds `<fasta>.pre` on the device; the gold run
    loads it."""
    base = _align_args(threads, batch)
    d = os.path.dirname(w["easy"])
    for mode in modes:
        tag = mode.strip("-")
        dev = os.path.join(d, f"device_{tag}.aln")
        gold = os.path.join(d, f"gold_{tag}.aln")
        align(f"{mode} device", w["easy"], w["easy_fq"], dev, base + [mode])
        align(f"{mode} gold", w["easy"], w["easy_fq"], gold,
              base + [mode, "--engine", "gold"])
        same_bytes(f"{mode} device vs gold", dev, gold)


def primary_launch(w: dict, threads: int, batch: int | None = None):
    """Inputs of one primary fixed-batch search launch on the multi-genome:
    the first `batch` reads, D bounds as the pipeline computes them, and
    the same static arguments as `bwbble align -n 4 -t T`."""
    import jax.numpy as jnp
    import numpy as np
    from bwbble_tpu.align.params import AlnParams
    from bwbble_tpu.engine.device_index import from_fmindex
    from bwbble_tpu.engine.inexact import EngineConfig
    from bwbble_tpu.engine.pipeline import calc_d_all
    from bwbble_tpu.formats.fastq import Reads, read_fastq
    from bwbble_tpu.index.fmindex import FMIndex

    kw = dict(max_diff=4, n_threads=threads)
    if batch:
        kw["batch_size"] = batch
    params = AlnParams(**kw)
    B = int(params.batch_size)
    idx = FMIndex.load(w["mg"] + ".bwt", load_sa=False)
    didx = from_fmindex(idx)
    r = read_fastq(w["mg_fq"])
    n = min(B, r.count)
    reads = Reads(names=r.names[:n], seq=r.seq[:n], rc=r.rc[:n],
                  qual=r.qual[:n], lengths=r.lengths[:n])
    D, Ds, _ = calc_d_all(didx, reads, params, batch=B, d_cap=32,
                          host_idx=idx)
    rc = np.zeros((B, max(reads.max_len, 1)), dtype=np.int8)
    rc[:n, :reads.rc.shape[1]] = reads.rc
    rc[n:] = rc[0]
    lengths = np.full(B, reads.lengths[0], dtype=np.int32)
    lengths[:n] = reads.lengths
    pad = np.concatenate([np.arange(n), np.zeros(B - n, np.int64)])
    D = jnp.take(jnp.asarray(D), jnp.asarray(pad), axis=0)
    Ds = jnp.take(jnp.asarray(Ds), jnp.asarray(pad), axis=0)
    cfg = EngineConfig(cap=int(params.arena_cap))
    return (didx, jnp.asarray(rc), jnp.asarray(lengths), D, Ds, params,
            cfg)


def summarize_trace(trace_dir: str, window: str, top: int = 12,
                    device_prefix: str = "/device:GPU") -> dict:
    """Reduce a jax.profiler trace to device busy time, idle share of the
    host window named `window`, and the top device operations by total
    duration.  Busy is the union of device-op intervals."""
    import glob
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise SmokeError(f"no trace under {trace_dir}")
    pd = ProfileData.from_file(paths[-1])
    win = None
    dev_lines: dict[str, list] = {}
    for plane in pd.planes:
        for line in plane.lines:
            evs = [(e.name, e.start_ns, e.duration_ns) for e in line.events]
            if plane.name.startswith("/host") and win is None:
                for name, s, dur in evs:
                    if name == window:
                        win = (s, s + dur)
            if plane.name.startswith(device_prefix):
                dev_lines[f"{plane.name}|{line.name}"] = evs
    # ops run on the stream lines; derived lines (XLA Ops / Modules / Steps)
    # repeat them, so they count only when no stream line exists
    streams = {k: v for k, v in dev_lines.items() if "|Stream" in k}
    ops = [e for v in (streams or dev_lines).values() for e in v]
    if not ops:
        raise SmokeError(f"no device events on {device_prefix} planes")
    lo = min(s for _, s, _ in ops)
    hi = max(s + d for _, s, d in ops)
    if win is None or not any(win[0] <= s <= win[1] for _, s, _ in ops):
        win = (lo, hi)        # host and device clocks not comparable
    ivs = sorted((max(s, win[0]), min(s + d, win[1])) for _, s, d in ops
                 if s + d > win[0] and s < win[1])
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in ivs:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    per_op: dict[str, list] = {}
    for name, _s, d in ops:
        t = per_op.setdefault(name, [0, 0.0])
        t[0] += 1
        t[1] += d
    top_ops = sorted(per_op.items(), key=lambda kv: -kv[1][1])[:top]
    span = max(win[1] - win[0], 1.0)
    return dict(lines=sorted(dev_lines), window_ns=span, busy_ns=busy,
                idle_share=1.0 - busy / span, n_ops=len(ops),
                top=[(n, c, d) for n, (c, d) in top_ops])


def phase_trace(w: dict, threads: int, batch: int | None = None,
                device_prefix: str = "/device:GPU") -> dict:
    """Phase 5: one traced primary launch of the XLA search body."""
    import jax
    from bwbble_tpu.engine.pipeline import _run_batch

    didx, rc, lengths, D, Ds, params, cfg = primary_launch(w, threads,
                                                           batch)
    run = lambda: jax.block_until_ready(  # noqa: E731
        _run_batch(didx, rc, lengths, params, cfg, None, D, Ds))
    timed("trace warm-up", run)
    tdir = os.path.join(w["dir"], "trace")
    with jax.profiler.trace(tdir):
        with jax.profiler.TraceAnnotation("smoke_primary_launch"):
            t0 = time.time()
            res = run()
            host_s = time.time() - t0
    iters = int(res["iters"])
    s = summarize_trace(tdir, "smoke_primary_launch",
                        device_prefix=device_prefix)
    print(f"[trace] device lines: {s['lines']}")
    print(f"[trace] lanes={int(rc.shape[0])} waves={iters} "
          f"host_s={host_s:.4f} window_ms={s['window_ns'] / 1e6:.3f} "
          f"device_busy_ms={s['busy_ns'] / 1e6:.3f} "
          f"idle_share={s['idle_share']:.4f} device_ops={s['n_ops']}")
    print(f"[trace] per wave: host_us={1e6 * host_s / max(iters, 1):.2f} "
          f"device_busy_us={s['busy_ns'] / 1e3 / max(iters, 1):.2f} "
          f"ops_per_wave={s['n_ops'] / max(iters, 1):.1f}")
    for name, cnt, dur in s["top"]:
        print(f"[trace] top op {dur / 1e6:10.3f} ms  x{cnt:<8d} {name}")
    sys.stdout.flush()
    return dict(iters=iters, host_s=host_s, **s)


# ------------------------------------------------------------- four cards

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_four(w: dict, threads: int) -> None:
    """Single-card .aln vs --mesh 4, --mesh 2,2 and four one-card --dist
    processes; every output must be byte-equal to the single-card run."""
    import jax
    d = os.path.dirname(w["mg"])
    # the large arena gives the device most reads (see phase_multigenome)
    base = _align_args(threads, None) + ["--arena", "327680"]
    dist = os.path.join(d, "dist.aln")
    port = _free_port()
    procs = []
    t0 = time.time()
    try:
        for rank in range(4):
            env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(rank))
            env.pop("XLA_PYTHON_CLIENT_PREALLOCATE", None)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "bwbble_tpu", "align", *base,
                 "--dist", f"localhost:{port},4,{rank}",
                 w["mg"], w["mg_fq"], dist], cwd=ROOT, env=env))
        rcs = [p.wait(timeout=420) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"[dist x4] wall_s={time.time() - t0:.2f} rcs={rcs}", flush=True)
    if any(rcs):
        raise SmokeError(f"--dist processes exited {rcs}")

    single = os.path.join(d, "single.aln")
    align("single card", w["mg"], w["mg_fq"], single, base)
    same_bytes("dist x4 vs single", dist, single)
    for spec in ("4", "2,2"):
        out = os.path.join(d, f"mesh_{spec.replace(',', 'x')}.aln")
        align(f"mesh {spec}", w["mg"], w["mg_fq"], out,
              base + ["--mesh", spec])
        same_bytes(f"mesh {spec} vs single", out, single)
    peaks = [peak_bytes(dv) for dv in jax.devices()[:4]]
    print(f"[four] peak_bytes_in_use per card: {peaks}", flush=True)
    if min(peaks) == 0:
        raise SmokeError(f"a card held no shard: {peaks}")


# ------------------------------------------------------------------- main

def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="four-card check only (mesh and --dist)")
    args = ap.parse_args(argv)

    if args.four:
        # the four --dist children each reserve most of their own card, so
        # this process allocates device memory only as it needs it
        os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"
    try:
        dev = check_device(expect_count=4 if args.four else None)
    except SmokeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    global _CLOCK
    _CLOCK = _CompileClock()
    cli.enable_compilation_cache()
    t_all = time.time()
    timed("native build", build_native_runtime)
    w, _, _ = timed("world + index", make_worlds, WORKDIR, READS)
    if args.four:
        run_four(w, THREADS)
    else:
        phase_multigenome(w, THREADS)
        phase_aln2sam(w)
        phase_single_and_precalc(w, THREADS)
        phase_trace(w, THREADS)
    print(f"total wall_s={time.time() - t_all:.2f} "
          f"compile_s={_CLOCK.total:.2f}", flush=True)
    import jax
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
