"""The device this process computes on, and where it keeps compiled code.

The compute device is the *effective default device*
(``jax.config.jax_default_device`` if set, else the first device of the
default backend): the tests pin work to the CPU by setting the default
device. Library calls run wherever that is; measurement paths call
:func:`require_gpu` and stop when it is not a GPU.
"""

from __future__ import annotations

import os
import subprocess
from dataclasses import dataclass

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclass(frozen=True)
class DeviceInfo:
    platform: str      # jax platform name: "gpu", "cpu", ...
    kind: str          # device_kind, e.g. "NVIDIA H100 80GB HBM3"
    count: int         # devices of that platform in this process

    def as_dict(self) -> dict:
        return {"platform": self.platform, "kind": self.kind,
                "count": self.count}


def device_info() -> DeviceInfo:
    dev = jax.config.jax_default_device or jax.devices()[0]
    return DeviceInfo(dev.platform, dev.device_kind,
                      len(jax.devices(dev.platform)))


def require_gpu() -> DeviceInfo:
    """The compute device, which must be a GPU: a measurement taken
    anywhere else would not be a device number."""
    info = device_info()
    if info.platform != "gpu":
        raise RuntimeError(
            f"no GPU: the compute device is {info.platform} "
            f"({info.kind}); measurements run only on a GPU")
    return info


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    ``$JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads it
    itself), else at ``<repo>/.jax_cache``. Returns the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(REPO_ROOT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_card_line() -> str:
    """``name, power.limit`` of each GPU as ``nvidia-smi`` reports them
    (one card: its line verbatim; several: their lines joined by
    ``"; "``), read by a child process that does not touch JAX. A card
    below its maximum power limit runs slower under load, so every
    time taken on it is reported beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())
