"""End-to-end paper driver: backbone features -> LPD-SVM classifier head
(PyTorch port of the JAX package's ``launch/train_svm.py``).

The paper's ImageNet experiment in miniature: a decoder-only backbone plays
VGG-16, its mean-pooled final hidden states are the feature vectors, and
LPD-SVM trains the one-vs-one classifier on top.  The backbone runs kernel
B4 (flash attention) in every attention layer on the card (an SSM backbone,
``--arch rwkv6-1.6b``, has none; jamba's Mamba layers and MoE FFNs are plain
tensor ops, as the reference's; ``--arch deepseek-v2-236b``'s MLA runs B4 at
its q / k width 96 and v width 64, ``--arch kimi-k2-1t-a32b``'s GQA at its
reduced head dim 64), and the head runs B1 / B2 (and B3 on the streamed
int8 wire).

    python -m repro_torch.launch.train_svm --arch qwen3-0.6b \
        --classes 10 --n 4000 --budget 256

runs on the card (there is no ``--device`` flag, as the reference has none);
the functions take ``device="cpu"`` for the plain versions of the kernels.
As in the reference the CLI builds the ``reduced()`` backbone from seed 0
(drawn from a ``torch.Generator``, so other weights than ``jax.random``'s);
``extract_features`` takes any ``Model``, the full-width one included.

The monolithic route and the streamed route (the ``StreamConfig`` fields the
port reads) are served, each with or without ``--polish`` (the coarse-to-fine
stage 2 of ``core/polish.py``, ``--polish-levels`` deep), and model selection
(``--grid-cs`` / ``--grid-gammas`` / ``--grid-folds``: ``core/cv.py``'s grid
search on the training split, on the grid task farm where it streams, then a
refit at the best cell).  ``--libsvm FILE`` (with ``--n-features`` and
``--on-bad-row``) trains from a LIBSVM text file instead of backbone
features: the file is read into CSR, stage 1 streams from the CSR without
ever building the dense (n, p) matrix, stage 2 streams, and the training
rows are scored from G (``train_from_libsvm``).  ``--trace OUT.json``,
``--trace-summary`` and ``--verbose`` arm a ``core/trace.py`` tracer for the
run (a Chrome-trace file, the summary, a line per streamed stage-2 epoch).
``--cache-budget-mb`` / ``--no-cache`` size or turn off the streamed stage
2's block cache (``core/block_cache.py``), and ``--checkpoint-dir`` /
``--checkpoint-every`` / ``--resume`` make both streamed stages resumable
(``core/resilience.py``).  ``--shard-dir DIR`` (``--shard-rows``,
``--verify-shards`` / ``--no-verify-shards``) is the disk tier
(``core/shards.py``): with ``--libsvm`` the text is parsed once into
checksummed shards under ``DIR/data`` (int8 shards with ``--stage1-dtype
int8``) and every later run streams them with no parse; ``--spill-g``
writes stage 1's G to shards under ``DIR/g_spill`` and runs stage 2 off
them.  ``--shard-dir`` forces the streamed pipelines.  On a host with
more than one card the streamed stage 2 runs on the multi-device task farm
(``core/distributed.py``), its workers behind one shared block reader;
``--no-overlap`` makes it the serial farm (each card's share re-reads G in
turn).  The stage-2 line prints the farm's device count.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.core import (GridResult, KernelParams, LPDSVM, StreamConfig,
                              grid_search, median_gamma)
from repro_torch.core.nystrom import compute_factor
from repro_torch.core.quant import GROUP_ROWS
from repro_torch.core.shards import ShardStore, ShardStoreStats, open_or_ingest
from repro_torch.core.streaming import (compute_factor_streamed_csr,
                                        compute_factor_streamed_shards)
from repro_torch.core.svm import resolve_device
from repro_torch.core.trace import ProgressPrinter, Tracer, install, uninstall
from repro_torch.data import CSRData, IngestStats, read_libsvm
from repro_torch.models.model import Model, init_model, trunk


@torch.no_grad()
def extract_features(cfg, model: Model, tokens: np.ndarray, batch: int = 32) -> np.ndarray:
    """Mean-pooled final hidden states (the trunk without the unembedding,
    then the final norm, then the mean over tokens in fp32) as a numpy
    (n, d_model) array, ``batch`` documents at a time on the model's device."""
    dev = model.embed.device
    outs = []
    for s in range(0, tokens.shape[0], batch):
        toks = torch.as_tensor(np.asarray(tokens[s:s + batch]), device=dev).long()
        outs.append(trunk(model, cfg, toks).to(torch.float32).mean(1))
    return torch.cat(outs).cpu().numpy()


def class_conditioned_tokens(n: int, n_classes: int, seq: int, vocab: int,
                             seed: int = 0, mix: float = 0.5):
    """Synthetic 'documents' whose token statistics depend on the class."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, size=n)
    # each class owns a band of preferred tokens
    band = vocab // (n_classes + 1)
    toks = rng.integers(0, vocab, size=(n, seq))
    for c in range(n_classes):
        mask = rng.random((n, seq)) < mix
        mask &= (y == c)[:, None]
        toks = np.where(mask, rng.integers(c * band, (c + 1) * band,
                                           size=(n, seq)), toks)
    return toks.astype(np.int32), y


@dataclasses.dataclass
class LibsvmResult:
    data: Optional[CSRData]       # the training file as read (None: from shards)
    svm: LPDSVM
    train_error: float            # of predict_from_factor on the training rows
    read_seconds: float           # the parse, or opening (or ingesting) the store
    ingest: IngestStats
    store: Optional[ShardStore] = None   # with --shard-dir: the data set's store
    ingested: bool = False        # the store was made by this run's parse
    shard_stats: Optional[ShardStoreStats] = None   # its disk traffic


def train_from_libsvm(args, stream_config: Optional[StreamConfig], *, device=None,
                      landmark_idx=None) -> LibsvmResult:
    """The out-of-core end-to-end route: LIBSVM file -> CSR -> streamed stage
    1 (``compute_factor_streamed_csr``) -> streamed stage 2.  The dense (n, p)
    matrix is never materialised; the training rows are scored from G.

    With ``--shard-dir`` the text is parsed once into the checksummed shard
    store under ``<shard-dir>/data`` (``shards.open_or_ingest``; int8 shards
    with ``--stage1-dtype int8``), and this run and every later one stream
    the verified shards (``compute_factor_streamed_shards``): a reused store
    parses no text.  ``device`` defaults to the card; ``landmark_idx``
    replaces the seeded landmark draw, so that a test can hold the route
    against the reference's draw."""
    device = resolve_device(device)
    cfg = stream_config or StreamConfig()
    gamma = args.gamma
    ingest = IngestStats()
    data = store = sstats = None
    ingested = False
    t0 = time.perf_counter()
    if args.shard_dir:
        sstats = ShardStoreStats()
        store, ingested = open_or_ingest(
            args.libsvm, os.path.join(args.shard_dir, "data"),
            n_features=args.n_features or None, shard_rows=cfg.shard_rows,
            dtype="int8" if args.stage1_dtype == "int8" else "f32",
            on_bad_row=args.on_bad_row, verify=cfg.verify_shards,
            retries=0 if cfg.fail_fast else cfg.max_retries,
            retry_backoff=cfg.retry_backoff, stats=sstats, trace=cfg.trace)
        t_read = time.perf_counter() - t0
        n, p = store.n, store.cols
        labels = store.labels()
        ingest.rows_read = int(store.manifest.get("rows_read", n))
        ingest.rows_skipped = int(store.manifest.get("rows_skipped", 0))
        gather = store.gather_rows
    else:
        data = read_libsvm(args.libsvm, n_features=args.n_features or None,
                           on_bad_row=args.on_bad_row, stats=ingest)
        t_read = time.perf_counter() - t0
        n, p = data.n, data.n_features
        labels = data.labels
        gather = data.densify_rows
    if ingest.rows_skipped:
        print(f"libsvm: skipped {ingest.rows_skipped} bad row(s) (--on-bad-row skip)")
    if gamma is None:
        # densify only a row subsample for the heuristic
        rows = np.random.default_rng(0).choice(n, min(256, n), replace=False)
        gamma = median_gamma(gather(np.sort(rows)))
    kp = KernelParams("rbf", gamma=gamma)
    t0 = time.perf_counter()
    if store is not None:
        factor = compute_factor_streamed_shards(store, kp, args.budget, seed=0,
                                                landmark_idx=landmark_idx, config=cfg,
                                                device=device)
    else:
        factor = compute_factor_streamed_csr(data, kp, args.budget, seed=0,
                                             landmark_idx=landmark_idx, config=cfg,
                                             device=device)
    args.gamma = gamma
    t_factor = time.perf_counter() - t0
    svm = LPDSVM(kp, C=args.C, budget=args.budget, tol=1e-2, stream=True,
                 stream_config=stream_config, polish=args.polish,
                 polish_levels=args.polish_levels, device=device)
    svm.fit(None, labels, factor=factor)
    svm.stats.stage1_seconds = t_factor   # the factor was computed out here
    err = float(np.mean(svm.predict_from_factor() != labels))
    print(f"libsvm: {n} rows x {p} features in {t_read:.1f}s")
    if store is not None:
        src = "ingested (parsed once)" if ingested else "reused (no parse)"
        print(f"shards: {store.n_shards} x {store.shard_rows} rows ({store.dtype}) "
              f"under {args.shard_dir} — {src}")
        print(_shard_io_line(sstats))
    _report(svm)
    print(f"train error: {err:.4f}")
    return LibsvmResult(data=data, svm=svm, train_error=err, read_seconds=t_read,
                        ingest=ingest, store=store, ingested=ingested,
                        shard_stats=sstats)


def _shard_io_line(st: ShardStoreStats) -> str:
    """The reference's ``shard io:`` line of a store's disk traffic."""
    line = (f"shard io: {st.shards_read} reads {st.bytes_read / 2**20:.1f} MiB "
            f"({st.read_gbps:.2f} GB/s), {st.verifications} verified")
    if st.checksum_failures:
        line += (f", {st.checksum_failures} corrupt -> {st.quarantined} quarantined / "
                 f"{st.rebuilt} rebuilt")
    if st.retries:
        line += f", {st.retries} retried"
    return line


def _report(svm: LPDSVM) -> None:
    s1 = svm.stats.stage1_stats
    s2 = svm.stats.stage2_stats
    print(f"stage1 {svm.stats.stage1_seconds:.2f}s (rank "
          f"{svm.stats.effective_rank}"
          f"{', streamed' if svm.stats.stage1_streamed else ''})  "
          f"stage2 {svm.stats.stage2_seconds:.2f}s "
          f"({svm.stats.n_tasks} binary SVMs"
          f"{', streamed' if svm.stats.stage2_streamed else ''})")
    if s1 is not None:
        scales = (f" ({s1.bytes_scales / 2**10:.1f} KiB scales)"
                  if s1.bytes_scales else "")
        resumed = (f", {s1.chunks_skipped} read back from the checkpoint"
                   if s1.chunks_skipped else "")
        print(f"stage1 stream: {s1.chunks} x {s1.wire_dtype} chunks{resumed}, "
              f"prefetch {s1.prefetch_final}, "
              f"{s1.bytes_h2d / 2**20:.1f} MiB H2D{scales}")
    if s2 is not None:
        print(f"stage2 stream: tile {s2.tile_rows} rows x {s2.block_dtype} "
              f"blocks, {s2.n_devices} device(s), prefetch {s2.prefetch_final}, "
              f"{s2.epochs} epochs, {s2.bytes_h2d / 2**20:.1f} MiB H2D / "
              f"{s2.bytes_d2h / 2**20:.1f} MiB D2H, active {s2.active_history}")
        # bytes_miss accrues with the cache off too; a line only where the
        # cache ran
        if s2.bytes_hit or s2.cache_resident_bytes:
            total = s2.bytes_hit + s2.bytes_miss
            print(f"stage2 cache: {s2.bytes_hit / 2**20:.1f} MiB hit / "
                  f"{s2.bytes_miss / 2**20:.1f} MiB miss "
                  f"({100 * s2.bytes_hit / total:.0f}% of compacted G bytes "
                  f"served from HBM), peak resident "
                  f"{s2.cache_resident_bytes / 2**20:.1f} MiB, "
                  f"{s2.cache_evictions} evictions")
    tr = svm.stats.polish_trace
    if tr is not None:
        for lv in tr.levels:
            finite = np.isfinite(lv.duality_gap)
            gap = float(np.max(lv.duality_gap[finite])) if finite.any() \
                else float("nan")
            print(f"polish level {lv.fraction:.4g}: {lv.n_rows} rows, "
                  f"tol {lv.tol:.3g}, {int(lv.epochs.max())} epochs max, "
                  f"gap {gap:.3g}, {lv.row_visits} row-visits"
                  f"{', streamed' if lv.streamed else ''}")
        print(f"polish total: {tr.total_row_visits} row-visits over "
              f"{len(tr.levels)} levels")


def _report_grid(res: GridResult, gammas, Cs) -> None:
    """Per-grid summary for --grid-*: the grid, each gamma's CV errors over
    the ascending Cs and, where the grid task farm ran, the one stream that
    gamma's whole grid trained in; then the selection."""
    print(f"grid: {len(gammas)} gammas x {len(Cs)} Cs, "
          f"{res.n_binary_solved} binary SVMs, "
          f"stage1 {res.stage1_seconds:.2f}s stage2 {res.stage2_seconds:.2f}s")
    for gi, gamma in enumerate(gammas):
        errs = " ".join(f"{e:.4f}" for e in res.errors[gi])
        line = f"  gamma {gamma:.4g}: err [{errs}]"
        if res.stream_stats is not None and res.stream_stats[gi] is not None:
            st = res.stream_stats[gi]
            line += (f"  farm: {st.epochs} epochs, "
                     f"{st.bytes_h2d / 2**20:.1f} MiB H2D "
                     f"({st.bytes_g / 2**20:.1f} MiB G blocks), "
                     f"{st.bytes_d2h / 2**20:.1f} MiB D2H, "
                     f"tile {st.tile_rows} x {st.block_dtype}")
        print(line)
    print(f"grid best: gamma={res.best_gamma:.4g} C={res.best_C:.4g} "
          f"err={res.best_error:.4f}")


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list_configs())
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--budget", type=int, default=256)
    ap.add_argument("--C", type=float, default=8.0)
    ap.add_argument("--gamma", type=float, default=None)
    ap.add_argument("--device-budget-mb", type=float, default=0.0,
                    help="device working-set budget for BOTH stages; >0 "
                         "auto-routes onto the out-of-core pipelines when the "
                         "monolithic working set exceeds it")
    ap.add_argument("--chunk-rows", type=int, default=0,
                    help="fixed stage-1 streaming chunk size (0 = derive from "
                         "budget; without --device-budget-mb this forces "
                         "streaming)")
    ap.add_argument("--tile-rows", type=int, default=0,
                    help="fixed stage-2 G block rows (0 = derive from budget)")
    ap.add_argument("--stream", action="store_true",
                    help="force the out-of-core pipelines (both stages)")
    ap.add_argument("--block-dtype", choices=("f32", "bf16", "int8"), default="f32",
                    help="wire dtype of streamed stage-2 G blocks (int8: codes "
                         "and a scale table, decoded on the card); a non-f32 "
                         "dtype forces streaming without a budget")
    ap.add_argument("--stage1-dtype", choices=("f32", "int8"), default="f32",
                    help="wire dtype of streamed stage-1 x chunks (forces "
                         "streaming without a budget)")
    ap.add_argument("--quant-group-rows", type=int, default=0,
                    help="rows per int8 scale group (0 = default 32)")
    ap.add_argument("--polish", action="store_true",
                    help="coarse-to-fine stage 2: solve nested row subsamples "
                         "(n/16 -> n/4 -> n by default) with tolerance "
                         "annealing, each level warm-starting the next, so the "
                         "full-data pass is a short polish (core/polish.py)")
    ap.add_argument("--polish-levels", type=int, default=3,
                    help="depth of the polish ladder (default 3)")
    ap.add_argument("--grid-cs", default=None,
                    help="comma-separated C grid: k-fold CV model selection "
                         "(core/cv.py) on the training split, then a refit "
                         "at the best cell")
    ap.add_argument("--grid-gammas", default=None,
                    help="comma-separated gamma grid (default: --gamma or the "
                         "median heuristic); needs --grid-cs")
    ap.add_argument("--grid-folds", type=int, default=3,
                    help="CV folds of the grid search (default 3)")
    ap.add_argument("--libsvm", default=None,
                    help="train from a LIBSVM-format file instead of backbone "
                         "features (the end-to-end out-of-core route)")
    ap.add_argument("--n-features", type=int, default=0,
                    help="feature count for --libsvm (0 = infer from the file)")
    ap.add_argument("--on-bad-row", choices=("raise", "skip"), default="raise",
                    help="--libsvm ingest policy for malformed or non-finite "
                         "rows: 'raise' (default) stops naming the line, "
                         "'skip' drops them and reports the count")
    ap.add_argument("--cache-budget-mb", type=float, default=-1.0,
                    help="bytes of the streamed stage 2's block cache on the "
                         "card (<0: what the device budget leaves, the "
                         "default; 0 turns the cache off)")
    ap.add_argument("--no-cache", action="store_true",
                    help="turn the stage-2 block cache off (every cheap epoch "
                         "ships its compacted rows again)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="checkpoint directory (core/resilience.py): stage 1 "
                         "keeps a resumable copy of G there, stage 2 "
                         "snapshots its solver at full passes; forces the "
                         "streamed pipelines")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    help="snapshot stage 2 every N full passes (default 1; "
                         "needs --checkpoint-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest snapshot in --checkpoint-dir; "
                         "bit-equal to the uninterrupted run")
    ap.add_argument("--shard-dir", default=None, metavar="DIR",
                    help="the disk tier (core/shards.py): with --libsvm, parse "
                         "the text once into checksummed binary shards under "
                         "DIR/data and stream every run from them (a later run "
                         "parses nothing); also the home of --spill-g's store; "
                         "forces the streamed pipelines")
    ap.add_argument("--shard-rows", type=int, default=4096,
                    help="rows a shard file (default 4096; a multiple of the "
                         "int8 group, so stored groups stay aligned to global "
                         "rows)")
    ap.add_argument("--spill-g", action="store_true",
                    help="write stage 1's G to f32 shards under --shard-dir and "
                         "run stage 2 off them (no host G of n rows)")
    ap.add_argument("--verify-shards", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="check each shard's digest on every read (default on; a "
                         "corrupt shard is quarantined and rebuilt from its "
                         "source; --no-verify-shards trusts the bytes)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="multi-device hosts: serial per-device streams instead "
                         "of the overlapped stage-2 task farm (each device "
                         "re-reads G)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record the run's timeline (core/trace.py; the card's "
                         "work as CUDA-event spans) and export it as "
                         "Chrome-trace JSON (ui.perfetto.dev)")
    ap.add_argument("--trace-summary", action="store_true",
                    help="print the trace summary (seconds per category, H2D "
                         "rate, overlap, the device rows' busy time)")
    ap.add_argument("--verbose", action="store_true",
                    help="print one line per streamed stage-2 epoch")
    return ap


def main(argv=None) -> float:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.chunk_rows < 0:
        ap.error(f"--chunk-rows must be >= 0, got {args.chunk_rows}")
    if args.tile_rows < 0:
        ap.error(f"--tile-rows must be >= 0, got {args.tile_rows}")
    if args.quant_group_rows < 0:
        ap.error(f"--quant-group-rows must be >= 0, got {args.quant_group_rows}")
    if args.polish_levels < 1:
        ap.error(f"--polish-levels must be >= 1, got {args.polish_levels}")
    if args.grid_folds < 2:
        ap.error(f"--grid-folds must be >= 2, got {args.grid_folds}")
    if args.grid_gammas is not None and args.grid_cs is None:
        ap.error("--grid-gammas requires --grid-cs")
    if args.checkpoint_every < 0:
        ap.error(f"--checkpoint-every must be >= 0, got {args.checkpoint_every}")
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume requires --checkpoint-dir")
    if args.shard_rows < 1:
        ap.error(f"--shard-rows must be >= 1, got {args.shard_rows}")
    if args.spill_g and not args.shard_dir:
        ap.error("--spill-g requires --shard-dir")

    stream_config, force = stream_args(args)
    if args.checkpoint_dir:
        print(f"checkpoint: {args.checkpoint_dir} (every "
              f"{args.checkpoint_every} full passes"
              f"{', resuming' if args.resume else ''})")
    if args.libsvm and args.grid_cs is not None:
        ap.error("--grid-cs is not supported with --libsvm")
    # any of the three flags arms a tracer, installed process-wide (every
    # instrumented path resolves it, with or without a StreamConfig) and put
    # in the StreamConfig where there is one; export and summary run in
    # `finally`, so a failed run still leaves its timeline
    tracer = None
    if args.trace or args.trace_summary or args.verbose:
        tracer = Tracer()
        if args.verbose:
            tracer.add_listener(ProgressPrinter())
        if stream_config is not None:
            stream_config = dataclasses.replace(stream_config, trace=tracer)
        install(tracer)
    try:
        if args.libsvm:
            return train_from_libsvm(args, stream_config).train_error
        return _run(args, ap, stream_config, force).test_error
    finally:
        if tracer is not None:
            uninstall()
            if args.trace:
                tracer.export(args.trace)
                print(f"trace: {tracer.n_events} events -> {args.trace}")
            if args.trace_summary:
                print(tracer.summary())


def _floats(csv: str):
    return [float(v) for v in csv.split(",")]


def stream_args(args):
    """(stream_config, force) from the streaming flags, as the reference
    derives them: an explicit chunk / tile size or wire dtype with no budget
    is a request to stream, not a hint to the (roomy) default budget;
    ``--stream``, ``--checkpoint-dir`` and ``--shard-dir`` (checkpoints and
    shards exist on the streamed pipelines only) force.
    ``--cache-budget-mb 0`` is ``--no-cache``; ``--no-overlap`` is
    ``overlap_devices=False``."""
    quant = args.block_dtype != "f32" or args.stage1_dtype != "f32"
    force = args.stream or bool(args.checkpoint_dir) or bool(args.shard_dir) or (
        (args.chunk_rows > 0 or args.tile_rows > 0 or quant)
        and args.device_budget_mb <= 0)
    cache_off = args.no_cache or args.cache_budget_mb == 0
    stream_config = None
    if (args.device_budget_mb > 0 or args.chunk_rows > 0 or args.tile_rows > 0
            or args.stream or quant or args.no_overlap or cache_off
            or args.cache_budget_mb > 0 or args.checkpoint_dir or args.shard_dir):
        stream_config = StreamConfig(
            device_budget_bytes=int(args.device_budget_mb * 2**20) or 2 << 30,
            chunk_rows=args.chunk_rows or None,
            tile_rows=args.tile_rows or None,
            block_dtype=args.block_dtype,
            stage1_dtype=args.stage1_dtype,
            quant_group_rows=args.quant_group_rows or GROUP_ROWS,
            overlap_devices=not args.no_overlap,
            cache_blocks=not cache_off,
            cache_budget_bytes=(int(args.cache_budget_mb * 2**20)
                                if args.cache_budget_mb > 0 else None),
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every if args.checkpoint_dir else 0,
            resume=args.resume,
            shard_dir=args.shard_dir,
            shard_rows=args.shard_rows,
            spill_g=args.spill_g,
            verify_shards=args.verify_shards)
    return stream_config, force


@dataclasses.dataclass
class DriverResult:
    features: np.ndarray          # (n, d_model) fp32
    n_train: int                  # the first n_train rows train the head
    svm: LPDSVM
    predictions: np.ndarray       # of the test rows
    test_error: float
    grid: Optional[GridResult] = None   # with --grid-cs: the search's result


def _run(args, ap, stream_config, force, *, model: Optional[Model] = None,
         device=None, landmark_idx=None) -> DriverResult:
    """Tokens -> backbone features -> LPD-SVM on an 80/20 split.  ``model``
    defaults to the ``reduced()`` backbone of ``--arch`` drawn from seed 0 on
    ``device`` (default the card).  ``landmark_idx`` (rows of the training
    split) replaces the head's seeded landmark draw, so that a test can hold
    the driver against the reference's draw."""
    device = resolve_device(device)
    cfg = get_config(args.arch, reduced=True)
    if model is None:
        gen = torch.Generator(device=device).manual_seed(0)
        model = init_model(gen, cfg, device=device)

    t0 = time.perf_counter()
    toks, y = class_conditioned_tokens(args.n, args.classes, args.seq,
                                       cfg.vocab_size)
    feats = extract_features(cfg, model, toks)
    t_feat = time.perf_counter() - t0
    if args.gamma is None:
        args.gamma = median_gamma(feats)
    n_tr = int(args.n * 0.8)
    stream = True if force else None

    grid = None
    if args.grid_cs is not None:
        Cs = _floats(args.grid_cs)
        gammas = _floats(args.grid_gammas) if args.grid_gammas else [args.gamma]
        t0 = time.perf_counter()
        grid = grid_search(feats[:n_tr], y[:n_tr], gammas, Cs,
                           budget=args.budget, folds=args.grid_folds,
                           stream=stream, stream_config=stream_config,
                           polish=args.polish,
                           polish_levels=args.polish_levels, device=device)
        print(f"features: {feats.shape} in {t_feat:.1f}s; "
              f"grid search {time.perf_counter() - t0:.1f}s")
        _report_grid(grid, gammas, Cs)
        # the refit at the best cell, unpolished, as the reference refits
        svm = LPDSVM(KernelParams("rbf", gamma=grid.best_gamma), C=grid.best_C,
                     budget=args.budget, tol=1e-2, stream=stream,
                     stream_config=stream_config, device=device)
    else:
        svm = LPDSVM(KernelParams("rbf", gamma=args.gamma), C=args.C,
                     budget=args.budget, tol=1e-2, stream=stream,
                     stream_config=stream_config, polish=args.polish,
                     polish_levels=args.polish_levels, device=device)
    factor = None
    if landmark_idx is not None:
        factor = compute_factor(feats[:n_tr], svm.kernel, args.budget,
                                landmark_idx=landmark_idx, device=device,
                                stream=svm.stream, stream_config=stream_config)
    svm.fit(feats[:n_tr], y[:n_tr], factor=factor)
    pred = svm.predict(feats[n_tr:])
    err = float(np.mean(pred != y[n_tr:]))
    if grid is None:
        print(f"features: {feats.shape} in {t_feat:.1f}s")
        _report(svm)
    print(f"test error: {err:.4f} (chance {1 - 1/args.classes:.2f})")
    return DriverResult(features=feats, n_train=n_tr, svm=svm, predictions=pred,
                        test_error=err, grid=grid)


if __name__ == "__main__":
    main()
