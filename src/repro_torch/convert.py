"""Carry the JAX package's fitted arrays across to the port.

The arrays arrive as numpy (``np.asarray`` of the reference's device arrays),
so this module needs nothing of the JAX package:

  * ``from_reference``: a fitted estimator from the reference's fitted state
    (the arrays its ``save`` writes: landmarks, projector, eigvals, W,
    classes, and the kernel parameters and C of its ``meta``);
  * ``factor_from_reference`` / ``tasks_from_reference``: a stage-1 factor G
    (device-resident, or host-resident for the streamed route) and a
    ``TaskBatch``, so stage 2 can be held against the reference on identical
    inputs;
  * ``model_from_reference``: a backbone ``Model`` from the reference's
    ``init_model`` parameter tree (a prefix model's, an encoder-decoder's
    with its ``encoder`` subtree and the layers' ``ln_x`` / ``cross``, an
    SSM or MoE model's mixers and experts, an MLA mixer's eight leaves;
    fp32 leaves stay fp32), so the port's layers can be held against the
    reference on identical weights;
  * ``opt_state_from_reference``: the port's ``OptState`` from the
    reference optimizer's (its step, and the m / v, factored or momentum
    trees), so training can continue from the reference's mid-run state.
    Adafactor factors a stacked leaf over its last two axes, so a stacked
    expert leaf's (n_groups, E, d) rows and (n_groups, E, f) columns split
    into each layer's (E, d) and (E, f), the port's own.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dual_solver import TaskBatch
from repro_torch.core.kernel_fn import KERNELS, KernelParams
from repro_torch.core.nystrom import LowRankFactor
from repro_torch.core.ovo import class_pairs
from repro_torch.core.streaming import host_buffer
from repro_torch.core.svm import LPDSVM, resolve_device
from repro_torch.models.model import Model, _layout
from repro_torch.optim import OptState


def _kernel_params(meta: Mapping) -> KernelParams:
    """``KernelParams`` from the reference's kernel fields; ``kind`` may be
    the name or the reference's saved index into ("rbf", "linear", "poly",
    "tanh")."""
    kind = meta["kind"]
    if not isinstance(kind, str):
        kind = KERNELS[int(kind)]
    return KernelParams(kind=kind, gamma=float(meta["gamma"]),
                        coef0=float(meta.get("coef0", 0.0)),
                        degree=int(meta.get("degree", 3)))


def _put(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)   # a copy


def factor_from_reference(state: Mapping[str, np.ndarray], kernel: KernelParams,
                          device=None, *, streamed: bool = False) -> LowRankFactor:
    """A ``LowRankFactor`` from the reference's landmarks, projector, eigvals
    and, where given, G (a fitted model loaded for prediction has none).

    ``streamed=True`` carries a streamed reference factor (its G is a host
    numpy buffer) across as a streamed port factor: G stays in host memory,
    pinned when the device is the card, and stage 2 streams it."""
    device = resolve_device(device)
    projector = _put(state["projector"], device)
    G = state.get("G")
    if G is None:
        G = torch.zeros((0, projector.shape[1]), device=device)
    elif streamed:
        src = torch.from_numpy(np.ascontiguousarray(G, np.float32))
        G = host_buffer(tuple(src.shape), torch.float32, device)
        G.copy_(src)
    else:
        G = _put(G, device)
    return LowRankFactor(G=G, landmarks=_put(state["landmarks"], device),
                         projector=projector, eigvals=_put(state["eigvals"], device),
                         effective_rank=projector.shape[1], kernel=kernel,
                         streamed=streamed)


def tasks_from_reference(idx, y, c, alpha0, device=None) -> TaskBatch:
    """The reference's ``TaskBatch`` fields as a port ``TaskBatch``."""
    device = resolve_device(device)
    return TaskBatch(idx=_put(idx, device, torch.int32), y=_put(y, device),
                     c=_put(c, device), alpha0=_put(alpha0, device))


def from_reference(state: Mapping[str, np.ndarray], kernel: Mapping,
                   device=None) -> LPDSVM:
    """A fitted port ``LPDSVM`` from the reference estimator's fitted arrays.

    ``kernel`` holds ``kind``, ``gamma``, ``coef0``, ``degree`` and ``C``, as
    the reference's saved ``meta`` does."""
    params = _kernel_params(kernel)
    svm = LPDSVM(kernel=params, C=float(kernel["C"]), device=device)
    svm.factor = factor_from_reference(state, params, svm.device)
    svm.W_ = _put(state["W"], svm.device)
    svm.classes_ = np.asarray(state["classes"])
    svm.pairs_ = class_pairs(len(svm.classes_))
    return svm


def _torch_dtype(a) -> torch.dtype:
    name = np.asarray(a).dtype.name
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), dtype=name)).dtype


def _leaves(tree, prefix: str) -> Iterator[Tuple[str, object]]:
    for key, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _leaves(sub, f"{prefix}{key}.")
        else:
            yield prefix + key, sub


def _unstack(stacked: Mapping, n: int, where: str, name_of) -> Dict[str, object]:
    """The leaves of a tree stacked over n layers on axis 0, one entry a
    layer: ``name_of(k, leaf name)`` -> layer k's slice.  A tuple leaf
    (Adafactor's (row, col) state) stacks each part."""
    out: Dict[str, object] = {}
    for name, leaf in _leaves(stacked, ""):
        parts = [np.asarray(a) for a in (leaf if isinstance(leaf, tuple) else (leaf,))]
        if any(a.shape[0] != n for a in parts):
            raise ValueError(f"model_from_reference: {where}.{name} stacks "
                             f"{parts[0].shape[0]} layers, the layout has {n}")
        for k in range(n):
            got = tuple(a[k] for a in parts)
            out[name_of(k, name)] = got if isinstance(leaf, tuple) else got[0]
    return out


def reference_leaves(params: Mapping, cfg) -> Dict[str, object]:
    """The reference's parameter tree as one array per port parameter name:
    ``prologue[i]`` is layer i, leaf ``[k]`` of ``groups[j]`` (stacked over
    groups) is layer ``n_prologue + k * group + j``, and leaf ``[k]`` of
    ``encoder.layers`` (stacked over the encoder's layers) is
    ``encoder.layers.k``."""
    pro, g, n_groups = _layout(cfg)
    out: Dict[str, object] = {}
    for key in ("embed", "final_ln", "unembed"):
        if key in params:
            out[key] = params[key]
    extra = set(params) - {"embed", "final_ln", "unembed", "prologue", "groups", "encoder"}
    if extra:
        raise KeyError(f"model_from_reference: no port counterpart for {sorted(extra)}")
    for i, layer in enumerate(params.get("prologue", [])):
        out.update(_leaves(layer, f"layers.{i}."))
    for j, stacked in enumerate(params.get("groups", [])):
        out.update(_unstack(stacked, n_groups, f"groups[{j}]",
                            lambda k, name: f"layers.{pro + k * g + j}.{name}"))
    if "encoder" in params:
        enc = params["encoder"]
        extra = set(enc) - {"layers", "final_ln"}
        if extra or "layers" not in enc:
            raise KeyError(f"model_from_reference: no port counterpart for encoder "
                           f"{sorted(extra) or 'without layers'}")
        out.update(_unstack(enc["layers"], cfg.n_encoder_layers, "encoder.layers",
                            lambda k, name: f"encoder.layers.{k}.{name}"))
        if "final_ln" in enc:
            out["encoder.final_ln"] = enc["final_ln"]
    return out


def model_from_reference(params: Mapping, cfg, device=None) -> Model:
    """A port ``Model`` carrying every leaf of the reference's ``init_model``
    tree (arrays as numpy; bf16 leaves arrive as ``ml_dtypes`` bfloat16 and go
    through fp32, which is exact).  Raises if a leaf has no port parameter or
    a port parameter gets no leaf."""
    device = resolve_device(device)
    leaves = reference_leaves(params, cfg)
    model = Model(cfg, generator=None, dtype=_torch_dtype(params["embed"]),
                  device=device)
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(leaves))
    unknown = sorted(set(leaves) - set(own))
    if missing or unknown:
        raise KeyError(f"model_from_reference: port parameters without a leaf "
                       f"{missing}, leaves without a port parameter {unknown}")
    for name, leaf in leaves.items():
        p = own[name]
        src = torch.from_numpy(np.array(leaf, dtype=np.float32))
        if tuple(src.shape) != tuple(p.shape) or _torch_dtype(leaf) != p.dtype:
            raise ValueError(f"model_from_reference: {name} is {np.asarray(leaf).dtype} "
                             f"{tuple(src.shape)}, the port's {p.dtype} {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(src.to(p.dtype))
    return model


def opt_state_from_reference(opt_state, cfg, device=None,
                             optimizer: Optional[str] = None) -> OptState:
    """The port's ``OptState`` (``repro_torch.optim``) from the reference's
    ``OptState(step, inner)`` (arrays as numpy) of the optimizer named
    ``optimizer`` (default ``cfg.optimizer``): AdamW's (m, v) trees,
    Adafactor's tree of (row, col) or full second moments, SGD's momentum
    tree, each as fp32 tensors by port parameter name on ``device``
    (None: the card)."""
    device = resolve_device(device)
    name = optimizer or cfg.optimizer

    def named(tree):
        out = {}
        for key, leaf in reference_leaves(tree, cfg).items():
            parts = tuple(_put(a, device) for a in
                          (leaf if isinstance(leaf, tuple) else (leaf,)))
            out[key] = parts if isinstance(leaf, tuple) else parts[0]
        return out

    step, inner = int(np.asarray(opt_state[0])), opt_state[1]
    if name == "adamw":
        return OptState(step, (named(inner[0]), named(inner[1])))
    if name == "adafactor":
        inner = dict(inner, groups=[{k: _unfactor_stacked_vectors(v) for k, v in
                                     layer.items()} for layer in inner.get("groups", [])])
        if "encoder" in inner:
            inner["encoder"] = dict(inner["encoder"], layers={
                k: _unfactor_stacked_vectors(v)
                for k, v in inner["encoder"]["layers"].items()})
        return OptState(step, named(inner))
    if name == "sgd":
        return OptState(step, named(inner))
    raise ValueError(f"unknown optimizer {name!r}")


def _unfactor_stacked_vectors(tree, eps: float = 1e-30):
    """The reference's Adafactor factors a stack of per-layer vectors (a
    norm's gain, a bias: (n_groups, d)) as a matrix, into a row statistic
    (n_groups,) across the layers and a column one (d,); the port keeps each
    layer's vector's full second moment.  Each layer's is the one the
    reference's update divides by, squared: vr[k] vc / max(mean(vr), eps)."""
    if isinstance(tree, Mapping):
        return {k: _unfactor_stacked_vectors(v, eps) for k, v in tree.items()}
    if isinstance(tree, tuple) and np.asarray(tree[0]).ndim == 1:
        vr, vc = (np.asarray(a, np.float32) for a in tree)
        return vr[:, None] * vc[None, :] / np.maximum(vr.mean(), np.float32(eps))
    return tree
