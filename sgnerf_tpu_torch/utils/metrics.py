"""Image quality metrics: PSNR / SSIM / RMSE (the port's copy of
`sgnerf_tpu/utils/metrics.py`; reference run/evaluate.py:34-97).

SSIM is the standard Wang et al. formulation with an 11x11 gaussian window
and the defaults skimage uses (gaussian_weights=True, sigma=1.5,
use_sample_covariance=False) as the reference calls it. LPIPS is
utils/lpips.py (plain torch on weight files the user supplies): without
them `lpips()` returns None and reports write nan, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def psnr(img: np.ndarray, ref: np.ndarray, max_val: float = 1.0) -> float:
    mse = float(np.mean((img.astype(np.float64) - ref.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(max_val ** 2 / mse)


def rmse(img: np.ndarray, ref: np.ndarray) -> float:
    return float(np.sqrt(np.mean(
        (img.astype(np.float64) - ref.astype(np.float64)) ** 2)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - size // 2
    k = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def _filter2d_sep(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' convolution along the first two axes."""
    from numpy.lib.stride_tricks import sliding_window_view
    w = len(k)
    out = sliding_window_view(img, w, axis=0) @ k
    out = sliding_window_view(out, w, axis=1) @ k
    return out


def ssim(img: np.ndarray, ref: np.ndarray, max_val: float = 1.0,
         win_size: int = 11, sigma: float = 1.5) -> float:
    """Mean SSIM over channels, gaussian-weighted windows."""
    img = img.astype(np.float64)
    ref = ref.astype(np.float64)
    if img.ndim == 2:
        img, ref = img[..., None], ref[..., None]
    k = _gaussian_kernel(win_size, sigma)
    C1 = (0.01 * max_val) ** 2
    C2 = (0.03 * max_val) ** 2
    vals = []
    for c in range(img.shape[2]):
        x, y = img[..., c], ref[..., c]
        mx = _filter2d_sep(x, k)
        my = _filter2d_sep(y, k)
        mxx = _filter2d_sep(x * x, k)
        myy = _filter2d_sep(y * y, k)
        mxy = _filter2d_sep(x * y, k)
        vx = mxx - mx ** 2
        vy = myy - my ** 2
        cxy = mxy - mx * my
        s = ((2 * mx * my + C1) * (2 * cxy + C2)) / (
            (mx ** 2 + my ** 2 + C1) * (vx + vy + C2))
        vals.append(s.mean())
    return float(np.mean(vals))


def lpips(img: np.ndarray, ref: np.ndarray,
          net: str = "alex", weights_path: Optional[str] = None,
          device="cpu"):
    """LPIPS perceptual distance on `device` (utils/lpips.py: an
    AlexNet/VGG16 trunk and the lpips package's linear calibration, from
    weight files the user supplies), or None when no weights are on disk
    (the reference omits the metric likewise without the lpips package)."""
    from .lpips import lpips_distance
    return lpips_distance(img, ref, net=net, weights_dir=weights_path,
                          device=device)


def mse2psnr(mse: float, max_val: float = 1.0) -> float:
    return 10.0 * np.log10(max_val ** 2 / max(mse, 1e-12))
