"""The run's device, its clocks and power, the process's start, and the
look for JAX in the process."""

from __future__ import annotations

import os
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "dl4ss_tpu")


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of
    its start (10 ms resolution), so that the interpreter's own start
    counts in the set-up."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def require_cards(chips: int) -> None:
    """Exit with code 2, printing no result, unless `chips` cards are
    there."""
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"benchmark: needs {chips} CUDA device(s), found {have}",
              file=sys.stderr)
        raise SystemExit(2)


def smi() -> str:
    """The card's name, clocks, power and temperature, or why not."""
    query = ("name,power.limit,power.draw,clocks.sm,clocks.mem,"
             "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return (out.stdout or out.stderr).strip()


def cpu_s() -> float:
    """This process's CPU seconds so far: over a window, against its wall
    time, whether the run held its core (a host-bound step slows with a
    shared host)."""
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def describe(device, chips: int) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                device))}
