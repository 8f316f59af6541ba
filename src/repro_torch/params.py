"""Load the JAX package's parameters into the port.

The reference keeps its parameter tree as nested dicts.  A decoder-only
model's block leaves are stacked ``[n_groups, ...]`` over layer groups
keyed ``l0..l{period-1}``; an encoder-decoder's ``enc_blocks`` and
``dec_blocks`` are each stacked ``[n_layers, ...]`` directly.
``from_jax_params`` takes that tree with **numpy** leaves (e.g.
``jax.tree.map(np.asarray, params)``, made by the caller) and returns the
state dict of ``models.transformer.Transformer`` (layer ``g * period + i``
taking group ``g``'s slice of ``l{i}``) or of ``models.encdec.EncDec``
(``enc_blocks.{i}`` and ``dec_blocks.{i}`` taking slice ``i`` of their
stack).  No JAX import happens here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.profiler import LengthPredictor, PredictorConfig


def _flatten(tree: dict, prefix: str, out: dict) -> None:
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            _flatten(val, name + ".", out)
        else:
            out[name] = val


def _unstack(stack: dict, name_of, out: dict) -> None:
    """Slice ``g`` of every stacked leaf of ``stack`` into
    ``out[name_of(g, leaf name)]``."""
    flat: dict = {}
    _flatten(stack, "", flat)
    for name, stacked in flat.items():
        for g in range(stacked.shape[0]):
            out[name_of(g, name)] = stacked[g]


def from_jax_params(tree: dict) -> dict[str, torch.Tensor]:
    """Reference parameter tree (numpy leaves) -> the port's state dict."""
    stacks = ("blocks", "enc_blocks", "dec_blocks")
    out: dict = {}
    _flatten({k: v for k, v in tree.items() if k not in stacks}, "", out)
    for key in ("enc_blocks", "dec_blocks"):
        if key in tree:
            _unstack(tree[key], lambda g, n, key=key: f"{key}.{g}.{n}", out)
    groups = tree.get("blocks", {})
    period = len(groups)
    for i in range(period):
        _unstack(groups[f"l{i}"],
                 lambda g, n, i=i: f"blocks.{g * period + i}.{n}", out)
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in out.items()}


def predictor_from_numpy(params: dict, cfg: PredictorConfig = PredictorConfig(),
                         *, device="cuda") -> LengthPredictor:
    """A ``LengthPredictor`` carrying the reference predictor's parameters
    ({"embed", "w1", "b1", "w2", "b2"} as numpy arrays)."""
    pred = LengthPredictor(cfg, device=device)
    with torch.no_grad():
        for name, p in pred.net.named_parameters():
            p.copy_(torch.from_numpy(np.array(params[name], copy=True)))
    return pred
