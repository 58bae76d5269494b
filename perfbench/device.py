"""What the result line says of the device, and its memory peak."""
from __future__ import annotations

import subprocess
from typing import Dict, Optional


def reset_peak(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device: str) -> int:
    if device.startswith("cuda"):
        import torch

        return int(torch.cuda.max_memory_allocated())
    return 0


def power_limit_w() -> Optional[float]:
    """The card's power limit in watts, from nvidia-smi (None where it
    cannot be read): the published peaks assume 700 W."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def info(device: str, peak: int) -> Dict:
    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": peak, "power_limit_w": power_limit_w()}
