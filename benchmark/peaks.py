"""Published peaks of the cards the benchmark knows, by a substring of
``torch.cuda.get_device_name()`` (NVIDIA's data sheets, dense rates,
at the card's full power limit).

``exp_per_s``: exponentials a second on the special-function units, 16 an
SM a clock over 132 SMs at 1.98 GHz.
"""
from __future__ import annotations

PEAKS = {
    "H100 80GB HBM3": {"tf32_flop_per_s": 494.7e12, "f32_flop_per_s": 66.9e12,
                       "hbm_bytes_per_s": 3.35e12, "exp_per_s": 16 * 132 * 1.98e9},
}


def peaks_for(device_name):
    """The peaks of the card named ``device_name``, or None."""
    for key, peaks in PEAKS.items():
        if key in (device_name or ""):
            return peaks
    return None
