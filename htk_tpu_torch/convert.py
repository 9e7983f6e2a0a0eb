"""Carry a compiled HMM set, a decode network, an n-gram LM, an ANN and
accumulators across to the port out of htk_tpu.

The JAX package's `CompiledHMMSet` (models/hmmset.py) and `DecodeNetwork`
(algo/net.py) hold numpy arrays; the port's copies of those modules
define the same dataclasses. These functions rebuild the port's objects
from any object with the same attributes (the JAX package's, read as
numpy arrays), and put them on a device, so that both packages compute
on identical operands; `ann_from` copies an ANNDef (models/ann.py:
numpy layers); `accumulators_from` turns the JAX package's
Baum-Welch accumulators into the port's, so that the two can be compared
field by field. Nothing here imports htk_tpu.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Tuple

import numpy as np

import torch

from .algo.decode import _net_dev, scorer_for
from .algo.fb import Accumulators
from .algo.net import DecodeNetwork
from .io.lm import NGramLM
from .models.ann import ANNDef, Layer
from .models.hmmset import CompiledHMMSet
from .ops.outp import GaussianScorer


def _carry(cls, src):
    """Copy every public dataclass field of `cls` from `src`: numpy
    arrays as fresh arrays, everything else as a deep copy."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name.startswith("_") or not hasattr(src, f.name):
            continue
        val = getattr(src, f.name)
        if isinstance(val, np.ndarray):
            val = np.array(val, copy=True)
        else:
            val = copy.deepcopy(val)
        kw[f.name] = val
    return cls(**kw)


def compiled_hmmset_from(comp) -> CompiledHMMSet:
    """The port's CompiledHMMSet from the JAX package's (means, variances,
    gconsts, state_mix, state_logw, transitions, model tables, ...)."""
    return _carry(CompiledHMMSet, comp)


def decode_network_from(net) -> DecodeNetwork:
    """The port's DecodeNetwork from the JAX package's (band, a0, aE,
    trans, start_entry, end_exit, chain and node tables, ...)."""
    return _carry(DecodeNetwork, net)


def ngram_lm_from(lm) -> NGramLM:
    """The port's NGramLM from the JAX package's (its order and n-gram
    dicts; a packed LM's dicts are materialised on reading)."""
    return NGramLM(order=lm.order, unigrams=dict(lm.unigrams),
                   bigrams=dict(lm.bigrams), trigrams=dict(lm.trigrams),
                   tri_bo=dict(lm.tri_bo), fourgrams=dict(lm.fourgrams))


def ann_from(ann) -> ANNDef:
    """The port's ANNDef from the JAX package's (name, context, priors,
    target names, and each layer's weight, bias and activation)."""
    out = _carry(ANNDef, ann)
    out.layers = [_carry(Layer, l) for l in ann.layers]
    return out


def accumulators_from(accs) -> Accumulators:
    """The port's Accumulators (float32 CPU tensors) from any object with
    the same fields (the JAX package's, read as numpy arrays)."""
    return Accumulators(**{
        f: torch.as_tensor(np.array(getattr(accs, f), np.float32))
        for f in Accumulators._fields})


def to_device(comp: CompiledHMMSet, net: DecodeNetwork, device,
              precision: str = "highest") -> Tuple[GaussianScorer, dict]:
    """The device tensors of a carried set and network: the packed
    Gaussian scorer and the network's tensor cache, as decode uses them."""
    return scorer_for(comp, device, precision), _net_dev(net, device)
