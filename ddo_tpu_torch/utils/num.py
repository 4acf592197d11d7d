"""Saturating int32 arithmetic used throughout the DD engine.

Counterpart of `ddo_tpu/utils/num.py`.  Objective values are int32 with
the sentinels +/- (2**30 - 1), so the sum of two saturated values still
fits in int32; every addition of objective-valued quantities goes through
`sat_add` / `sat_sub`, which clamp back into [NEG_INF, INF].  The int32
sum itself wraps like XLA's, so results agree bit for bit with ddo_tpu
even on out-of-range inputs.
"""

import torch

VALUE_DTYPE = torch.int32

#: +infinity sentinel for objective values (mirrors isize::MAX).
INF = (1 << 30) - 1
#: -infinity sentinel for objective values (mirrors isize::MIN).
NEG_INF = -INF


def sat_add(a, b):
    """Saturating addition over int32 objective tensors."""
    return torch.clamp(a + b, NEG_INF, INF)


def sat_sub(a, b):
    """Saturating subtraction over int32 objective tensors."""
    return torch.clamp(a - b, NEG_INF, INF)


def argmax_first(x):
    """Index of the first maximum along the last dim (jnp.argmax's tie
    rule, which torch.argmax does not promise)."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    return torch.where(x == x.amax(dim=-1, keepdim=True), idx, n).amin(dim=-1)


def argmin_first(x):
    """Index of the first minimum along the last dim (jnp.argmin's tie rule)."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    return torch.where(x == x.amin(dim=-1, keepdim=True), idx, n).amin(dim=-1)
