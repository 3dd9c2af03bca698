"""Published peak rates per device, keyed by ``jax.Device.device_kind``.

Source: NVIDIA H100 data sheet, SXM part, dense rates without sparsity, at
the full 700 W power limit.  A card set below that limit cannot hold these
rates, so every roofline share is reported beside the card's power limit.
"""
from __future__ import annotations

_H100_SXM = {
    "bf16_tflops": 989.0,
    "fp16_tflops": 989.0,
    "fp8_tflops": 1979.0,
    "int8_tops": 1979.0,
    "tf32_tflops": 495.0,
    "fp32_tflops": 67.0,
    "hbm_tbps": 3.35,
    "source": "NVIDIA H100 data sheet (SXM, dense, 700 W)",
}

PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}

# the peak that bounds a product in each storage dtype
_DTYPE_KEY = {"bfloat16": "bf16_tflops", "float16": "fp16_tflops",
              "float32": "tf32_tflops", "int8": "int8_tops",
              "float8_e4m3fn": "fp8_tflops"}


def peaks_for(device_kind: str) -> dict:
    """The peak table of one device; an unknown device is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {device_kind!r}; add its "
            f"data-sheet rates to sparta_tpu/bench/peaks.py") from None


def peak_flops(device_kind: str, dtype) -> float:
    """Peak operations per second for a product stored in ``dtype``."""
    import numpy as np

    name = np.dtype(dtype).name
    return peaks_for(device_kind)[_DTYPE_KEY[name]] * 1e12
