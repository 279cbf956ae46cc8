"""What the program ran on: JAX's device record and the card's power limit."""

from __future__ import annotations

import subprocess


def device_record() -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports the devices."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def gpu_name_power() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them.

    A card set below its maximum power runs slower under load, so every
    number a benchmark keeps goes beside this line.
    """
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.replace("\n", " | ")
