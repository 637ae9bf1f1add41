"""Dense layers with the reference's initializers, and their product in a
compute dtype (counterpart of nonrigid_nerf_tpu/models/mlp.py:17-80).

Layers are `nn.Linear` (weight (fan_out, fan_in)); `weights.py` transposes
the JAX (fan_in, fan_out) arrays on load. NR-NeRF's "start from straight
rays" behaviour depends on these initializations
(reference: run_nerf_helpers.py:434-454,502-505).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# the names ModelConfig.compute_dtype takes
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dense(fan_in: int, fan_out: int, init: str = "torch_default",
          bias: bool = True, generator: Optional[torch.Generator] = None,
          device=None) -> nn.Linear:
    """One dense layer, initialised with `generator`.

    init modes:
      "torch_default": weight, bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))
          (nn.Linear's default; the canonical NeRF MLP);
      "kaiming_relu": weight ~ U(-sqrt(6/fan_in), sqrt(6/fan_in)), bias 0
          (the bending/rigidity hidden layers);
      "zeros": zero weight and bias (the bending/rigidity output layers);
      "siren_first"/"siren": U(-1/fan_in, 1/fan_in) for the first layer,
          U(-sqrt(6/fan_in), sqrt(6/fan_in)) after, bias 0.
    """
    layer = nn.Linear(fan_in, fan_out, bias=bias, device=device)
    bounds = {"torch_default": 1.0 / math.sqrt(fan_in),
              "kaiming_relu": math.sqrt(6.0 / fan_in),
              "siren_first": 1.0 / fan_in,
              "siren": math.sqrt(6.0 / fan_in),
              "zeros": 0.0}
    if init not in bounds:
        raise ValueError(f"unknown init {init!r}")
    bound = bounds[init]
    with torch.no_grad():
        if bound > 0.0:
            nn.init.uniform_(layer.weight, -bound, bound, generator=generator)
        else:
            layer.weight.zero_()
        if bias:
            if init == "torch_default":
                nn.init.uniform_(layer.bias, -bound, bound, generator=generator)
            else:
                layer.bias.zero_()
    return layer


def compute_dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a ModelConfig.compute_dtype name."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={name!r}; known: "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def dense_apply(layer: nn.Linear, x: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x @ w^T + b, as JAX's `dense_apply` (models/mlp.py:63-80) computes it.

    In float32 this is `layer(x)` (and float64 stays float64). In a lower
    compute dtype the input and the weight are rounded to it, their product
    accumulates in f32, the f32 bias is added, and the output is rounded to
    the compute dtype once. The product runs in f32 on the rounded operands:
    bf16 x bf16 products are exact in f32, so this is the function of a bf16
    GEMM with an f32 output, and autograd and forward-mode AD (the jvps of
    the view directions and the divergence loss) go through it. On a GPU it
    needs TF32 off for matrix products (PyTorch's default)."""
    if compute_dtype == torch.float32:
        return layer(x)
    w = layer.weight.to(compute_dtype).float()
    y = F.linear(x.to(compute_dtype).float(), w, layer.bias)
    return y.to(compute_dtype)
