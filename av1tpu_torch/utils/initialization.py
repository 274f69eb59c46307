"""Seeded model initialization on the host.

The port's counterpart of ``av1tpu.utils.initialization``. ``init_on_cpu``
draws a module's parameters on the CPU from an explicit ``torch.Generator``
(flax's initializers, ``models.layers.init_like_flax``), whatever device the
caller serves on, so that one seed gives the same weights on every machine
and card: a CUDA generator draws other numbers than a CPU one. The result
is a ``{"params", "batch_stats"}`` tree of numpy arrays in the JAX
package's layout, which ``models.jax_import.load_jax_variables`` loads into
a model on any device.
"""
from __future__ import annotations

import copy
from typing import Dict, Union

import torch
from torch import nn

from av1tpu_torch.models.jax_import import to_jax_variables
from av1tpu_torch.models.layers import init_like_flax


def init_on_cpu(model: nn.Module, rngs: Union[torch.Generator, int], *args,
                **kwargs) -> Dict[str, Dict]:
    """``model``'s variables drawn on the CPU from ``rngs`` (a CPU
    ``torch.Generator``, or an int seed for one), as flax's ``model.init``
    draws them: lecun-normal conv and dense weights, zero biases, BatchNorm
    scale 1, bias 0 and running statistics 0 / 1. ``model`` itself is left
    as it is, on its device. ``args`` and ``kwargs``, when given, are a
    sample input (flax's ``init`` traces one): the drawn model runs one
    eval-mode forward on them on the CPU, which checks that they fit.

    Returns the ``{"params", "batch_stats"}`` tree of numpy arrays that
    ``models.jax_import.load_jax_variables`` reads."""
    gen = torch.Generator().manual_seed(rngs) if isinstance(rngs, int) else rngs
    if gen.device.type != "cpu":
        raise ValueError(f"init_on_cpu draws from a CPU generator, got one on {gen.device}")
    drawn = init_like_flax(copy.deepcopy(model).to("cpu"), gen)
    if args or kwargs:
        with torch.no_grad():
            drawn.eval()(*(_cpu(a) for a in args),
                         **{k: _cpu(v) for k, v in kwargs.items()})
    return to_jax_variables(drawn.state_dict())


def _cpu(value):
    return value.cpu() if isinstance(value, torch.Tensor) else value


__all__ = ["init_on_cpu"]
