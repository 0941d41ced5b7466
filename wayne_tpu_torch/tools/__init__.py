"""The science tools of the port, by the names of the repository's
``tools/`` scripts they stand for:

- :mod:`.program_ephemeris`: a program's ephemeris drift and combined
  spectrum from its reduced visits;
- :mod:`.validate_recovery`: ensemble depth recovery and sigma
  calibration in twelve sections -> ``VALIDATION_TORCH.json``;
- :mod:`.uncertainty_triangle`: LM sigma, MCMC width and Monte-Carlo
  scatter side by side -> ``UNCERTAINTY_TORCH.json``.

Each runs on the CUDA card unless ``--cpu`` (``device="cpu"``) is given,
and raises without a card. Importing this package builds no kernel.
"""

from __future__ import annotations

import os
import subprocess

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def card_name(device: torch.device) -> str | None:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (the device's own line),
    or None on the CPU. Without ``nvidia-smi`` the name alone."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        return out[device.index or 0].strip()
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(device)
