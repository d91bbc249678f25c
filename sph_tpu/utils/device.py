"""Device checks for the measurement paths (``bench.py``, ``chip_smoke.py``).

A timing or smoke run means something only on the GPU it is meant for, so
these paths stop when JAX finds none instead of falling back to the CPU.
"""
from __future__ import annotations

import subprocess


def require_gpu():
    """The first JAX device; exits (status 1, reason on stderr) if it is
    not a GPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is on "
                         f"{dev.platform!r}; refusing to measure there")
    return dev


def card_info() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())
