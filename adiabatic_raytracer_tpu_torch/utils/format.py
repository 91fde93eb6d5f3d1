"""Julia-compatible number formatting.

The reference encodes run parameters into output filenames with Julia's
`string(x)` (MainRunner.jl:750-761).  Byte-identical filenames matter for the
combine step and downstream analysis scripts, so we reproduce Julia's Float64
shortest-round-trip printing: decimal notation for 1e-4 <= |x| < 1e6, else
`m.mmm...eN` with a mandatory fractional digit and bare exponent.
"""

from __future__ import annotations

import math


def julia_float_str(x: float) -> str:
    x = float(x)
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "Inf" if x > 0 else "-Inf"
    if x == 0.0:
        return "-0.0" if math.copysign(1.0, x) < 0 else "0.0"

    neg = x < 0
    s = repr(abs(x))  # shortest round-trip decimal from CPython (Ryu-equivalent)
    if "e" in s or "E" in s:
        mant, exp = s.lower().split("e")
        exp = int(exp)
    else:
        mant, exp = s, 0
    int_len = mant.index(".") if "." in mant else len(mant)
    # scientific exponent e: x = d.ddd * 10^e
    first_sig = next(i for i, c in enumerate(mant.replace(".", "")) if c != "0")
    e = int_len - 1 - first_sig + exp
    digits = mant.replace(".", "").lstrip("0").rstrip("0") or "0"

    if -5 < e < 6:
        # decimal notation
        if e >= 0:
            if len(digits) <= e + 1:
                out = digits + "0" * (e + 1 - len(digits)) + ".0"
            else:
                out = digits[: e + 1] + "." + digits[e + 1:]
        else:
            out = "0." + "0" * (-e - 1) + digits
    else:
        frac = digits[1:] or "0"
        out = f"{digits[0]}.{frac}e{e}"
    return ("-" if neg else "") + out


def julia_str(x) -> str:
    """Julia `string(x)` for the types appearing in filenames (Int, Float64)."""
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, int):
        return str(x)
    return julia_float_str(x)
