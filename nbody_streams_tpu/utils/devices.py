"""Device introspection and health checks.

Reference-equivalent of ``get_gpu_info`` (reference: fields.py:1149) and
``cuda_alive`` (reference: tree_gpu/_force.py:57-83), for any JAX
backend.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["get_device_info", "device_alive"]


def get_device_info(device=None) -> dict:
    """Backend/device description: platform, kind, memory stats if
    available, device count."""
    devices = jax.devices()
    dev = device or devices[0]
    info = {
        "platform": dev.platform,
        "device_kind": getattr(dev, "device_kind", "unknown"),
        "id": dev.id,
        "n_devices": len(devices),
        "process_index": getattr(dev, "process_index", 0),
        "default_backend": jax.default_backend(),
    }
    try:
        stats = dev.memory_stats()
        if stats:
            info["bytes_in_use"] = stats.get("bytes_in_use")
            info["bytes_limit"] = stats.get("bytes_limit")
    except Exception:
        pass
    return info


def device_alive(device=None) -> bool:
    """Cheap end-to-end health check: run one op and read it back."""
    try:
        x = jnp.arange(8.0)
        if device is not None:
            x = jax.device_put(x, device)
        return bool(np.isclose(float(jnp.sum(x)), 28.0))
    except Exception:
        return False
