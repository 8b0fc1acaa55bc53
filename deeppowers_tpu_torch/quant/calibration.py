"""Calibration observers for post-training quantization, ported from
deeppowers_tpu/quant/calibration.py (its numpy arithmetic, copied).

Observers are plain Python objects fed tensors (torch tensors, moved to
the host, or anything numpy takes); `finalize()` produces ranges that
`quantize(..., scales=...)` consumes.

Methods: MINMAX (running extrema), PERCENTILE (histogram clip),
MSE (scale sweep minimizing reconstruction error), ENTROPY / KL_DIVERGENCE
(KL-divergence clip, TensorRT-style), over a 2048-bin histogram of |x|.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import CalibrationMethod

_HIST_BINS = 2048


def _host(x) -> np.ndarray:
    """x as f32 numpy: a torch tensor (any device) or an array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


class Observer:
    """Accumulates statistics of every tensor passed to update()."""

    def __init__(self, method: CalibrationMethod = CalibrationMethod.MINMAX,
                 percentile: float = 99.9, axis: Optional[int] = None):
        self.method = method
        self.percentile = percentile
        self.axis = axis  # None => per-tensor; int => per-channel along axis
        self.num_samples = 0
        self._min: Optional[np.ndarray] = None
        self._max: Optional[np.ndarray] = None
        self._sum: Optional[np.ndarray] = None
        self._sumsq: Optional[np.ndarray] = None
        self._count = 0
        self._hist: Optional[np.ndarray] = None
        self._hist_absmax: float = 0.0

    # -- accumulation -------------------------------------------------------
    def update(self, x) -> None:
        x = _host(x)
        if self.axis is None:
            mn, mx = float(x.min()), float(x.max())
            s, ss, cnt = float(x.sum()), float((x * x).sum()), x.size
        else:
            reduce_axes = tuple(i for i in range(x.ndim) if i != self.axis % x.ndim)
            mn = x.min(axis=reduce_axes)
            mx = x.max(axis=reduce_axes)
            s = x.sum(axis=reduce_axes)
            ss = (x * x).sum(axis=reduce_axes)
            cnt = x.size // x.shape[self.axis % x.ndim]
        if self._min is None:
            self._min, self._max = np.asarray(mn), np.asarray(mx)
            self._sum, self._sumsq = np.asarray(s, dtype=np.float64), np.asarray(
                ss, dtype=np.float64)
        else:
            self._min = np.minimum(self._min, mn)
            self._max = np.maximum(self._max, mx)
            self._sum = self._sum + s
            self._sumsq = self._sumsq + ss
        self._count += cnt
        self.num_samples += 1
        if self.method in (CalibrationMethod.PERCENTILE, CalibrationMethod.ENTROPY,
                           CalibrationMethod.KL_DIVERGENCE,
                           CalibrationMethod.MSE):
            self._update_hist(x)

    def _update_hist(self, x: np.ndarray) -> None:
        absmax = float(np.abs(x).max())
        if self._hist is None:
            self._hist = np.zeros(_HIST_BINS, dtype=np.float64)
            self._hist_absmax = max(absmax, 1e-8)
        elif absmax > self._hist_absmax:
            # Rescale existing histogram into the wider range.
            old_edges = np.linspace(0, self._hist_absmax, _HIST_BINS + 1)
            centers = (old_edges[:-1] + old_edges[1:]) / 2
            new_hist = np.zeros(_HIST_BINS, dtype=np.float64)
            idx = np.minimum(
                (centers / absmax * _HIST_BINS).astype(np.int64), _HIST_BINS - 1)
            np.add.at(new_hist, idx, self._hist)
            self._hist = new_hist
            self._hist_absmax = absmax
        h, _ = np.histogram(np.abs(x), bins=_HIST_BINS,
                            range=(0, self._hist_absmax))
        self._hist += h

    # -- finalization -------------------------------------------------------
    @property
    def minmax(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._min is None:
            raise RuntimeError("observer has no samples")
        return self._min, self._max

    @property
    def mean(self) -> np.ndarray:
        return np.asarray(self._sum) / max(self._count, 1)

    @property
    def var(self) -> np.ndarray:
        m = self.mean
        return np.asarray(self._sumsq) / max(self._count, 1) - m * m

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        """Return (range_min, range_max) per the configured method."""
        mn, mx = self.minmax
        if self.method == CalibrationMethod.MINMAX:
            return mn, mx
        if self.method == CalibrationMethod.PERCENTILE:
            t = self._percentile_threshold(self.percentile)
        elif self.method in (CalibrationMethod.ENTROPY,
                             CalibrationMethod.KL_DIVERGENCE):
            t = self._entropy_threshold()
        elif self.method == CalibrationMethod.MSE:
            t = self._mse_threshold()
        else:  # pragma: no cover
            raise ValueError(self.method)
        return np.maximum(mn, -t), np.minimum(mx, t)

    def scale_symmetric(self, qmax: int) -> np.ndarray:
        mn, mx = self.finalize()
        absmax = np.maximum(np.abs(mn), np.abs(mx))
        return np.maximum(absmax, 1e-8) / qmax

    # -- clipping strategies -------------------------------------------------
    def _percentile_threshold(self, pct: float) -> float:
        cdf = np.cumsum(self._hist)
        cdf = cdf / cdf[-1]
        bin_idx = int(np.searchsorted(cdf, pct / 100.0))
        return (bin_idx + 1) / _HIST_BINS * self._hist_absmax

    def _entropy_threshold(self) -> float:
        """KL-divergence-minimizing clip threshold (TensorRT calibration)."""
        hist = self._hist / max(self._hist.sum(), 1e-12)
        best_kl, best_t = np.inf, self._hist_absmax
        # Sweep candidate thresholds over the top half of the histogram.
        for stop in range(_HIST_BINS // 8, _HIST_BINS + 1, _HIST_BINS // 64):
            p = hist[:stop].copy()
            outliers = hist[stop:].sum()
            p[-1] += outliers
            psum = p.sum()
            if psum <= 0:
                continue
            p /= psum
            # Quantize the clipped distribution into 128 levels then expand.
            nlevels = 128
            factor = stop / nlevels
            q = np.zeros(stop)
            for i in range(nlevels):
                lo, hi = int(i * factor), int((i + 1) * factor)
                hi = max(hi, lo + 1)
                chunk = p[lo:hi]
                nz = (chunk > 0).sum()
                if nz:
                    q[lo:hi] = np.where(chunk > 0, chunk.sum() / nz, 0)
            qsum = q.sum()
            if qsum <= 0:
                continue
            q /= qsum
            mask = p > 0
            kl = float(np.sum(p[mask] * np.log(p[mask] / np.maximum(q[mask], 1e-12))))
            if kl < best_kl:
                best_kl = kl
                best_t = stop / _HIST_BINS * self._hist_absmax
        return best_t

    def _mse_threshold(self) -> float:
        """Clip threshold minimizing expected squared quantization error
        against the histogram density (127-level symmetric grid)."""
        centers = (np.arange(_HIST_BINS) + 0.5) / _HIST_BINS * self._hist_absmax
        hist = self._hist
        best_err, best_t = np.inf, self._hist_absmax
        for frac in np.linspace(0.3, 1.0, 36):
            t = frac * self._hist_absmax
            scale = t / 127.0
            q = np.clip(np.round(centers / scale), -127, 127) * scale
            err = float(np.sum(hist * (centers - q) ** 2))
            if err < best_err:
                best_err, best_t = err, t
        return best_t


class Calibrator:
    """Named-tensor observer registry: call `observe(name, x)` during
    forward passes, then `finalize()` for per-name ranges."""

    def __init__(self, method: CalibrationMethod = CalibrationMethod.MINMAX,
                 percentile: float = 99.9):
        self.method = method
        self.percentile = percentile
        self.observers: Dict[str, Observer] = {}

    def observe(self, name: str, x, axis: Optional[int] = None) -> None:
        if name not in self.observers:
            self.observers[name] = Observer(
                self.method, self.percentile, axis=axis)
        self.observers[name].update(x)

    def finalize(self) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        return {name: ob.finalize() for name, ob in self.observers.items()}

    def scales(self, qmax: int = 127) -> Dict[str, np.ndarray]:
        return {name: ob.scale_symmetric(qmax) for name, ob in self.observers.items()}

    @property
    def num_samples(self) -> int:
        return max((ob.num_samples for ob in self.observers.values()), default=0)
