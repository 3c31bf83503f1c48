"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).

Copied from ``chip_smoke.py`` (its module constants ``H100_FP32_FLOPS``,
``H100_BF16_FLOPS``, ``H100_TF32_FLOPS``, ``H100_INT8_OPS``,
``H100_HBM_BYTES``). Every share of a peak is stated against these, with
the card's power limit (`power_limit_w`) beside it.
"""

from __future__ import annotations

FP32_FLOPS = 67e12      # FP32 outside the tensor cores
BF16_FLOPS = 989e12     # dense bf16 tensor cores
TF32_FLOPS = 495e12     # dense TF32 tensor cores
INT8_OPS = 1979e12      # dense int8 tensor cores
HBM_BYTES = 3.35e12     # HBM3 bytes/s


def card_line():
    """``name, power.limit`` of card 0 as nvidia-smi prints them, or None
    where nvidia-smi cannot be run."""
    import subprocess
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None
