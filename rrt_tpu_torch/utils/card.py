"""What the card is: its name and power limit, its SM clock and its
float32 peak, as measurements on it must be labelled and normalised.

Everything here asks the card (`nvidia-smi`, `torch.cuda`) when called,
and raises when there is no card to ask.
"""
from __future__ import annotations

import subprocess

import torch

# float32 lanes per SM on Hopper (outside the tensor cores), each one FMA
# (two flops) per clock
FP32_LANES_PER_SM = 128


def _smi_lines(query: str) -> list:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()


def _smi(query: str) -> str:
    return _smi_lines(query)[0]


def card_line() -> str:
    """`name, power limit` of the first card, as nvidia-smi prints them."""
    return _smi("name,power.limit")


def card_lines() -> list:
    """`name, power limit` of every card, one line each, as nvidia-smi
    prints them."""
    return _smi_lines("name,power.limit")


def topology() -> str:
    """How the cards are joined (`nvidia-smi topo -m`: NVLink, PCIe), or
    why it could not be read."""
    try:
        out = subprocess.run(["nvidia-smi", "topo", "-m"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi topo -m failed: {e}"
    if out.returncode != 0:
        return (f"nvidia-smi topo -m failed ({out.returncode}): "
                f"{(out.stderr or out.stdout).strip()}")
    return out.stdout.rstrip()


def max_sm_clock_mhz() -> float:
    """The first card's maximum SM clock in MHz."""
    return float(_smi("clocks.max.sm").split()[0])


def fp32_peak_flops(device, sm_clock_mhz: float) -> float:
    """Float32 (non-tensor-core) peak of the card: SMs × 128 lanes × 2
    flops × SM clock; 66.9 TFLOP/s for an H100 SXM at 1980 MHz."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * FP32_LANES_PER_SM * 2.0 * sm_clock_mhz * 1e6
