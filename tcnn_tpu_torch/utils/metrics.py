"""Image/error metrics (reference: scripts/common.py:47-165): the port's own
copy of ``tcnn_tpu/utils/metrics.py:1-65``. numpy on host arrays."""

from __future__ import annotations

import numpy as np


def srgb_to_linear(img: np.ndarray) -> np.ndarray:
    limit = 0.04045
    return np.where(img > limit, ((img + 0.055) / 1.055) ** 2.4, img / 12.92)


def linear_to_srgb(img: np.ndarray) -> np.ndarray:
    limit = 0.0031308
    return np.where(img > limit, 1.055 * img ** (1.0 / 2.4) - 0.055, 12.92 * img)


def luminance(a: np.ndarray) -> np.ndarray:
    return 0.212671 * a[..., 0] + 0.715160 * a[..., 1] + 0.072169 * a[..., 2]


def L1(img, ref):
    return np.abs(img - ref)


def APE(img, ref):  # absolute percentage error
    return L1(img, ref) / (1e-2 + np.abs(ref))


def SAPE(img, ref):  # symmetric APE
    return L1(img, ref) / (1e-2 + (np.abs(ref) + np.abs(img)) / 2)


def L2(img, ref):
    return (img - ref) ** 2


def RSE(img, ref):  # relative squared error
    return L2(img, ref) / (1e-2 + ref * ref)


def compute_error(metric: str, img: np.ndarray, ref: np.ndarray) -> float:
    table = {
        "MAE": L1,
        "MAPE": APE,
        "SMAPE": SAPE,
        "MSE": L2,
        "MScE": lambda i, r: L2(np.clip(i, 0, 1), np.clip(r, 0, 1)),
        "MRSE": RSE,
        "MtRSE": lambda i, r: np.minimum(RSE(i, r), 1.0),
        "MRScE": lambda i, r: np.clip(
            RSE(np.clip(i, 0, 100), np.clip(r, 0, 100)), 0, 100
        ),
    }
    if metric not in table:
        raise ValueError(f"Unknown metric: {metric}")
    return float(np.mean(table[metric](img.astype(np.float64),
                                       ref.astype(np.float64))))


def psnr(img: np.ndarray, ref: np.ndarray, peak: float = 1.0) -> float:
    mse = float(np.mean((img.astype(np.float64) - ref.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)
