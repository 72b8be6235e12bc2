"""Deterministic Q-format gradient all-reduce (the port of
``repro.optim.compress``).

The paper's insight — integer arithmetic makes reductions order-invariant
— applied to cross-pod gradient sync, over an explicit list of per-pod
gradient trees (the reference runs the same steps under a ``pod`` mesh
axis):

  1. consistent scale: each tensor's max|g| over every pod (a float max,
     order-invariant);
  2. quantize to a narrow Q-contract (int16 at Q2.13 by default) with
     round-half-away-from-zero, saturating;
  3. an integer sum over the pods in the contract's ``acc_dtype`` — exact
     and associative, so bit-identical whatever the pods' order;
  4. dequantize, then divide by the pod count; optional error feedback
     carries each pod's quantization residual into its next step.

Every float operation is the reference's, in its order, so the mean and
the residuals equal the reference's bit for bit.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.contracts import PrecisionContract, get_contract
from repro_torch.optim.adamw import Tree, named


def _quantize(g: torch.Tensor, scale: torch.Tensor, c: PrecisionContract
              ) -> torch.Tensor:
    """g/scale ∈ [-1, 1] → raw fixed point (saturating, round-half-away)."""
    x = g.to(torch.float32) / torch.clamp(scale, min=1e-30)
    s = x * c.one
    r = torch.sign(s) * torch.floor(torch.abs(s) + 0.5)
    return torch.clamp(r, c.min_raw, c.max_raw).to(c.storage_dtype)


def _dequantize(raw: torch.Tensor, scale: torch.Tensor, c: PrecisionContract
                ) -> torch.Tensor:
    return raw.to(torch.float32) * (scale / c.one)


@torch.no_grad()
def integer_psum_grads(
    grads: Sequence[Tree],
    contract: str = "Q2.13",
    residuals: Optional[Sequence[Mapping[str, torch.Tensor]]] = None,
) -> Tuple[Dict[str, torch.Tensor],
           Optional[List[Dict[str, torch.Tensor]]]]:
    """The deterministic mean of one gradient tree per pod.

    ``grads[i]`` (and ``residuals[i]``) may live on pod i's own device.
    Returns (the mean tree, on the first pod's device; each pod's new
    residual tree on its device, or None without ``residuals``)."""
    c = get_contract(contract)
    trees = [named(g) for g in grads]
    n = len(trees)
    dev0 = next(iter(trees[0].values())).device
    mean: Dict[str, torch.Tensor] = {}
    new_res = None if residuals is None else [{} for _ in range(n)]
    for name, g0 in trees[0].items():
        g32 = [t[name].to(torch.float32) for t in trees]
        if residuals is not None:
            g32 = [g + residuals[i][name] for i, g in enumerate(g32)]
        scale = torch.stack([torch.max(torch.abs(g)).to(dev0)
                             for g in g32]).max()
        raws = [_quantize(g, scale.to(g.device), c) for g in g32]
        summed = raws[0].to(c.acc_dtype).to(dev0)
        for raw in raws[1:]:
            summed = summed + raw.to(c.acc_dtype).to(dev0)
        mean[name] = (_dequantize(summed, scale, c) / float(n)).to(g0.dtype)
        if new_res is not None:
            # error feedback: what each pod failed to transmit
            for i, (g, raw) in enumerate(zip(g32, raws)):
                new_res[i][name] = g - _dequantize(raw, scale.to(g.device),
                                                   c)
    return mean, new_res
