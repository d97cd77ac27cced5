"""Adam with torch.optim.Adam update semantics, as plain tensor functions.

Counterpart of splatam_tpu/slam/optim.py. The reference builds a fresh
torch Adam per frame and phase (scripts/splatam.py:680,822) with eps 1e-8
for tracking and 1e-15 for mapping. Parameters and moments are tuples of
tensors.

    m_t = b1*m + (1-b1)*g ; v_t = b2*v + (1-b2)*g^2
    p  -= lr/(1-b1^t) * m_t / ( sqrt(v_t/(1-b2^t)) + eps )
"""
from __future__ import annotations

from typing import NamedTuple

import torch

BETA1 = 0.9
BETA2 = 0.999


class AdamState(NamedTuple):
    m: tuple
    v: tuple
    step: int


def adam_init(params: tuple) -> AdamState:
    return AdamState(
        m=tuple(torch.zeros_like(p) for p in params),
        v=tuple(torch.zeros_like(p) for p in params),
        step=0,
    )


def adam_step(state: AdamState, params: tuple, grads: tuple, lrs: tuple,
              eps: float):
    """One step; lrs holds one float per param. Returns (params, state)."""
    t = state.step + 1
    bc1 = 1.0 - BETA1**t
    bc2 = 1.0 - BETA2**t
    new_m = tuple(BETA1 * m + (1.0 - BETA1) * g for m, g in zip(state.m, grads))
    new_v = tuple(BETA2 * v + (1.0 - BETA2) * g * g for v, g in zip(state.v, grads))
    new_p = []
    for p, m, v, lr in zip(params, new_m, new_v, lrs):
        new_p.append(p - (lr / bc1) * m / (torch.sqrt(v / bc2) + eps))
    return tuple(new_p), AdamState(m=new_m, v=new_v, step=t)


def reset_slots(state: AdamState, mask: torch.Tensor) -> AdamState:
    """Zero the moments of the slots selected by mask [CAP]."""

    def z(x):
        shaped = mask.reshape((mask.shape[0],) + (1,) * (x.ndim - 1))
        return torch.where(shaped, torch.zeros_like(x), x)

    return AdamState(m=tuple(z(x) for x in state.m),
                     v=tuple(z(x) for x in state.v), step=state.step)
