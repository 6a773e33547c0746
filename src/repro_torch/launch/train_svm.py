"""End-to-end paper driver: backbone features -> LPD-SVM classifier head
(PyTorch port of the JAX package's ``launch/train_svm.py``).

The paper's ImageNet experiment in miniature: a decoder-only backbone plays
VGG-16, its mean-pooled final hidden states are the feature vectors, and
LPD-SVM trains the one-vs-one classifier on top.  The backbone runs kernel
B4 (flash attention) in every layer on the card, and the head runs B1 / B2
(and B3 on the streamed int8 wire).

    python -m repro_torch.launch.train_svm --arch qwen3-0.6b \
        --classes 10 --n 4000 --budget 256

runs on the card (there is no ``--device`` flag, as the reference has none);
the functions take ``device="cpu"`` for the plain versions of the kernels.
As in the reference the CLI builds the ``reduced()`` backbone from seed 0
(drawn from a ``torch.Generator``, so other weights than ``jax.random``'s);
``extract_features`` takes any ``Model``, the full-width one included.

The monolithic route and the streamed route (the ``StreamConfig`` fields the
port reads) are served.  Flags of routes not ported yet stop with an error
that names them.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.core import KernelParams, LPDSVM, StreamConfig, median_gamma
from repro_torch.core.nystrom import compute_factor
from repro_torch.core.quant import GROUP_ROWS
from repro_torch.core.svm import resolve_device
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
        print(f"stage1 stream: {s1.chunks} x {s1.wire_dtype} chunks, "
              f"prefetch {s1.prefetch_final}, "
              f"{s1.bytes_h2d / 2**20:.1f} MiB H2D{scales}")
    if s2 is not None:
        print(f"stage2 stream: tile {s2.tile_rows} rows x {s2.block_dtype} "
              f"blocks, 1 device, prefetch {s2.prefetch_final}, "
              f"{s2.epochs} epochs, {s2.bytes_h2d / 2**20:.1f} MiB H2D / "
              f"{s2.bytes_d2h / 2**20:.1f} MiB D2H, active {s2.active_history}")


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags, those of routes not ported yet included (they
    are refused by ``main``)."""
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
                    help="wire dtype of streamed stage-2 G blocks (int8: not "
                         "ported yet); a non-f32 dtype forces streaming "
                         "without a budget")
    ap.add_argument("--stage1-dtype", choices=("f32", "int8"), default="f32",
                    help="wire dtype of streamed stage-1 x chunks (forces "
                         "streaming without a budget)")
    ap.add_argument("--quant-group-rows", type=int, default=0,
                    help="rows per int8 scale group (0 = default 32)")
    # routes of the reference that are not ported yet: refused by main()
    ap.add_argument("--no-overlap", action="store_true")
    ap.add_argument("--cache-budget-mb", type=float, default=-1.0)
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--polish", action="store_true")
    ap.add_argument("--polish-levels", type=int, default=3)
    ap.add_argument("--grid-cs", default=None)
    ap.add_argument("--grid-gammas", default=None)
    ap.add_argument("--grid-folds", type=int, default=3)
    ap.add_argument("--libsvm", default=None)
    ap.add_argument("--n-features", type=int, default=0)
    ap.add_argument("--on-bad-row", choices=("raise", "skip"), default="raise")
    ap.add_argument("--shard-dir", default=None, metavar="DIR")
    ap.add_argument("--shard-rows", type=int, default=4096)
    ap.add_argument("--spill-g", action="store_true")
    ap.add_argument("--verify-shards", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR")
    ap.add_argument("--checkpoint-every", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--trace", default=None, metavar="OUT.json")
    ap.add_argument("--trace-summary", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    return ap


def _unported(args) -> Optional[str]:
    """The first flag of a route the port does not serve yet, or None."""
    given = (("--libsvm", args.libsvm is not None),
             ("--n-features", args.n_features != 0),
             ("--on-bad-row", args.on_bad_row != "raise"),
             ("--grid-cs", args.grid_cs is not None),
             ("--grid-gammas", args.grid_gammas is not None),
             ("--grid-folds", args.grid_folds != 3),
             ("--polish", args.polish),
             ("--polish-levels", args.polish_levels != 3),
             ("--checkpoint-dir", args.checkpoint_dir is not None),
             ("--checkpoint-every", args.checkpoint_every != 1),
             ("--resume", args.resume),
             ("--shard-dir", args.shard_dir is not None),
             ("--shard-rows", args.shard_rows != 4096),
             ("--spill-g", args.spill_g),
             ("--no-verify-shards", not args.verify_shards),
             ("--trace", args.trace is not None),
             ("--trace-summary", args.trace_summary),
             ("--verbose", args.verbose),
             ("--cache-budget-mb", args.cache_budget_mb != -1.0),
             ("--no-cache", args.no_cache),
             ("--no-overlap", args.no_overlap),
             ("--block-dtype int8", args.block_dtype == "int8"))
    return next((flag for flag, set_ in given if set_), None)


def main(argv=None) -> float:
    ap = build_parser()
    args = ap.parse_args(argv)
    flag = _unported(args)
    if flag is not None:
        ap.error(f"{flag} is not ported to repro_torch yet")
    if args.chunk_rows < 0:
        ap.error(f"--chunk-rows must be >= 0, got {args.chunk_rows}")
    if args.tile_rows < 0:
        ap.error(f"--tile-rows must be >= 0, got {args.tile_rows}")
    if args.quant_group_rows < 0:
        ap.error(f"--quant-group-rows must be >= 0, got {args.quant_group_rows}")

    stream_config, force = stream_args(args)
    return _run(args, ap, stream_config, force).test_error


def stream_args(args):
    """(stream_config, force) from the streaming flags, as the reference
    derives them: an explicit chunk / tile size or wire dtype with no budget
    is a request to stream, not a hint to the (roomy) default budget;
    ``--stream`` forces."""
    quant = args.block_dtype != "f32" or args.stage1_dtype != "f32"
    force = args.stream or ((args.chunk_rows > 0 or args.tile_rows > 0 or quant)
                            and args.device_budget_mb <= 0)
    stream_config = None
    if (args.device_budget_mb > 0 or args.chunk_rows > 0 or args.tile_rows > 0
            or args.stream or quant):
        stream_config = StreamConfig(
            device_budget_bytes=int(args.device_budget_mb * 2**20) or 2 << 30,
            chunk_rows=args.chunk_rows or None,
            tile_rows=args.tile_rows or None,
            block_dtype=args.block_dtype,
            stage1_dtype=args.stage1_dtype,
            quant_group_rows=args.quant_group_rows or GROUP_ROWS)
    return stream_config, force


@dataclasses.dataclass
class DriverResult:
    features: np.ndarray          # (n, d_model) fp32
    n_train: int                  # the first n_train rows train the head
    svm: LPDSVM
    predictions: np.ndarray       # of the test rows
    test_error: float


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

    svm = LPDSVM(KernelParams("rbf", gamma=args.gamma), C=args.C,
                 budget=args.budget, tol=1e-2,
                 stream=True if force else None,
                 stream_config=stream_config, device=device)
    factor = None
    if landmark_idx is not None:
        factor = compute_factor(feats[:n_tr], svm.kernel, args.budget,
                                landmark_idx=landmark_idx, device=device,
                                stream=svm.stream, stream_config=stream_config)
    svm.fit(feats[:n_tr], y[:n_tr], factor=factor)
    pred = svm.predict(feats[n_tr:])
    err = float(np.mean(pred != y[n_tr:]))
    print(f"features: {feats.shape} in {t_feat:.1f}s")
    _report(svm)
    print(f"test error: {err:.4f} (chance {1 - 1/args.classes:.2f})")
    return DriverResult(features=feats, n_train=n_tr, svm=svm, predictions=pred,
                        test_error=err)


if __name__ == "__main__":
    main()
