"""The comparison that decides ``correct``.

``numbers(out, ref)`` reads, over every element of the program's output
``out`` against the reference's unrounded values ``ref`` (float64):

* ``excess_ulp``: the largest |out - ref| in units of the output dtype's
  spacing at |ref|, less the half unit that rounding to that dtype costs
  at best.  Rounded once from a float32 sum, it reads near 0; a further
  rounding, a coarser operand or a wrong element reads 0.3 and more;
* ``mismatch_share``: the share of elements that differ from ``ref``
  rounded to the output dtype;
* ``max_ulp``: the largest |out - ref| in units of that spacing.

A NaN or an infinity in ``out`` reads infinity.  ``judge`` holds the
numbers named in a cell's file to their limits.
"""

from __future__ import annotations

import math
import sys
from typing import Dict

import torch

# mantissa bits (with the hidden one) and the least normal exponent
_FORMATS = {torch.bfloat16: (8, -126), torch.float16: (11, -14),
            torch.float32: (24, -126), torch.float64: (53, -1022)}
_BLOCK = 1 << 24


def spacing(ref: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The spacing of ``dtype`` at |ref| (float64): 2^(e - p + 1) for
    |ref| in [2^e, 2^(e+1)), and the subnormal spacing below the least
    normal number."""
    bits, emin = _FORMATS[dtype]
    _, e = torch.frexp(ref.abs())
    e = torch.where(ref == 0, float(emin), e.to(torch.float64) - 1.0)
    e = torch.clamp(e, min=float(emin))
    return torch.exp2(e - (bits - 1))


def numbers(out: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    if tuple(out.shape) != tuple(ref.shape):
        raise ValueError(f"output shape {tuple(out.shape)} is not the "
                         f"reference's {tuple(ref.shape)}")
    if out.dtype not in _FORMATS:
        raise ValueError(f"no comparison for output dtype {out.dtype}")
    o = out.reshape(-1)
    r = ref.reshape(-1)
    worst, mism, n = 0.0, 0, o.numel()
    for i in range(0, n, _BLOCK):
        ob = o[i:i + _BLOCK]
        rb = r[i:i + _BLOCK].to(torch.float64)
        ulps = (ob.to(torch.float64) - rb).abs() / spacing(rb, out.dtype)
        ulps = torch.where(torch.isfinite(ulps), ulps,
                           torch.full_like(ulps, math.inf))
        worst = max(worst, float(ulps.max()) if ulps.numel() else 0.0)
        mism += int((ob != rb.to(out.dtype)).sum())
    return {"excess_ulp": worst - 0.5, "mismatch_share": mism / max(n, 1),
            "max_ulp": worst}


def merge(a: Dict[str, float], b: Dict[str, float], na: int, nb: int):
    """The numbers of two compared sets as one: the worst of the maxima,
    the shares weighted by size."""
    if not a:
        return dict(b)
    return {"excess_ulp": max(a["excess_ulp"], b["excess_ulp"]),
            "max_ulp": max(a["max_ulp"], b["max_ulp"]),
            "mismatch_share": (a["mismatch_share"] * na
                               + b["mismatch_share"] * nb) / (na + nb)}


def _finite(v: float) -> float:
    return v if math.isfinite(v) else sys.float_info.max


def judge(nums: Dict[str, float], limits: Dict[str, dict]):
    """(correct, {name: {'value', 'limit'}}) for the numbers the cell
    names; a number above its limit, or not a number, is not correct."""
    # JSON has no infinity: a number past every limit prints as the
    # largest double
    checks = {name: {"value": _finite(nums[name]),
                     "limit": float(spec["limit"])}
              for name, spec in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
