"""Debug / observability.

Reference: /root/reference/src/debug.c — NDArray_Dump struct dump
(debug.c:17-46), NumPy-style pretty printer with `...` elision
(debug.c:58-184), CUDA device-property dump (debug.c:218-258); plus buffer
allocation counters (buffer.c:15-18).

Here dump() reports the jax.Array's sharding/committed device(s) and
layout instead of strides/refcounts; dump_devices() reports the JAX device
topology (platform, kind, process index, memory stats where exposed).
"""

from __future__ import annotations

import jax
import numpy as np


def dump(a) -> str:
    """NDArray_Dump analogue (debug.c:17-46)."""
    lines = [
        "numpower_tpu.Array {",
        f"  dtype: {a.dtype}",
        f"  ndim: {a.ndim}",
        f"  shape: {tuple(a.shape)}",
        f"  size: {a.size}",
        f"  nbytes: {a.nbytes}",
    ]
    if isinstance(a, jax.Array):
        try:
            lines.append(f"  sharding: {a.sharding}")
            devs = sorted({d.id for d in a.devices()})
            lines.append(f"  devices: {devs}")
            lines.append(f"  committed: {a.committed}")
        except Exception:
            pass
    lines.append("}")
    out = "\n".join(lines)
    print(out)
    return out


def dump_devices() -> str:
    """dumpDevices analogue (debug.c:218-258) for the JAX topology."""
    lines = []
    for d in jax.devices():
        entry = f"[{d.id}] {d.platform}:{d.device_kind} process={d.process_index}"
        try:
            stats = d.memory_stats()
            if stats:
                used = stats.get("bytes_in_use", 0)
                limit = stats.get("bytes_limit", 0)
                entry += f" mem={used}/{limit}"
        except Exception:
            pass
        lines.append(entry)
    lines.append(f"process_count={jax.process_count()} local_devices={jax.local_device_count()}")
    out = "\n".join(lines)
    print(out)
    return out


def array_repr(a, precision: int = 8, edgeitems: int = 3, threshold: int = 1000) -> str:
    """Pretty printer with large-array elision (debug.c:102-115) — delegates
    to numpy's printer, which implements the identical `...` truncation."""
    host = np.asarray(jax.device_get(a))
    with np.printoptions(precision=precision, edgeitems=edgeitems,
                         threshold=threshold, suppress=True):
        return np.array2string(host, separator=", ")
