"""Device selection for the port's entry points."""

from __future__ import annotations

import subprocess

import torch


def card_name_and_power_limit(index: int = 0) -> str:
    """The card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them.  Every time the port reports is stated beside this line: a card
    set below its maximum power runs slower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return `device` as a torch.device.  A CUDA device must exist: the
    port's entry points run on the card, and only an explicit "cpu" (the
    tests) runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' explicitly to run on the CPU")
    return dev
