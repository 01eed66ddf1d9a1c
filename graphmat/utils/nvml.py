"""The GPU's name and power limit, read through NVML with ctypes.

Every device number this repository reports stands beside the card's name
and power limit, because a card set below its maximum power runs slower
under load.  :func:`gpu_name_power_limit` formats them exactly as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` does,
without starting a child process.
"""

from __future__ import annotations

import ctypes

__all__ = ["gpu_name_power_limit"]


def gpu_name_power_limit() -> list[str]:
    """One ``"<name>, <limit> W"`` line per GPU NVML sees; raises
    ``OSError`` when NVML is absent (no NVIDIA driver)."""
    lib = ctypes.CDLL("libnvidia-ml.so.1")

    def check(rc, what):
        if rc != 0:
            raise OSError(f"NVML {what} failed with status {rc}")

    check(lib.nvmlInit_v2(), "init")
    try:
        count = ctypes.c_uint()
        check(lib.nvmlDeviceGetCount_v2(ctypes.byref(count)), "count")
        lines = []
        for i in range(count.value):
            handle = ctypes.c_void_p()
            check(lib.nvmlDeviceGetHandleByIndex_v2(
                i, ctypes.byref(handle)), "handle")
            name = ctypes.create_string_buffer(96)
            check(lib.nvmlDeviceGetName(handle, name, 96), "name")
            milliwatts = ctypes.c_uint()
            check(lib.nvmlDeviceGetPowerManagementLimit(
                handle, ctypes.byref(milliwatts)), "power limit")
            lines.append(f"{name.value.decode()}, "
                         f"{milliwatts.value / 1000:.2f} W")
        return lines
    finally:
        lib.nvmlShutdown()
