"""Streaming feature standardization.

Replaces the reference's dependency on ``sklearn.preprocessing.StandardScaler``
(`bin/calc_stats.py:21-27`, `bin/train.py:464-470`) with a small,
dependency-free implementation of the same streaming mean/variance
(Chan et al. parallel update, which is what sklearn's ``partial_fit`` does).
"""

from __future__ import annotations

import numpy as np


class StandardScaler:
    """Streaming per-dimension mean / scale estimator.

    ``partial_fit`` accumulates over (T, D) arrays; ``mean_`` / ``scale_``
    expose the same attributes the reference reads and writes to stats.h5.
    ``scale_`` is the population standard deviation with near-zero variances
    clamped to 1.0 (sklearn's ``_handle_zeros_in_scale`` behavior).
    """

    def __init__(self) -> None:
        self.n_samples_seen_: int = 0
        self._mean: np.ndarray | None = None
        self._m2: np.ndarray | None = None
        self._scale: np.ndarray | None = None

    def partial_fit(self, x: np.ndarray) -> "StandardScaler":
        x = np.asarray(x, dtype=np.float64)
        if x.ndim == 1:
            x = x[:, None]
        n_b = x.shape[0]
        if n_b == 0:
            return self
        mean_b = x.mean(axis=0)
        m2_b = ((x - mean_b) ** 2).sum(axis=0)
        if self._mean is None:
            self._mean = mean_b
            self._m2 = m2_b
            self.n_samples_seen_ = n_b
        else:
            n_a = self.n_samples_seen_
            delta = mean_b - self._mean
            n = n_a + n_b
            self._mean = self._mean + delta * (n_b / n)
            self._m2 = self._m2 + m2_b + delta**2 * (n_a * n_b / n)
            self.n_samples_seen_ = n
        return self

    @property
    def mean_(self) -> np.ndarray:
        assert self._mean is not None, "scaler has not been fit"
        return self._mean

    @mean_.setter
    def mean_(self, value: np.ndarray) -> None:
        self._mean = np.asarray(value, dtype=np.float64)

    @property
    def var_(self) -> np.ndarray:
        assert self._m2 is not None, "scaler has not been fit"
        return self._m2 / self.n_samples_seen_

    @property
    def scale_(self) -> np.ndarray:
        if self._m2 is None:
            assert self._scale is not None
            return self._scale
        scale = np.sqrt(self.var_)
        # avoid division by ~0 for constant dims (sklearn behavior)
        scale[scale < 10 * np.finfo(np.float64).eps] = 1.0
        return scale

    @scale_.setter
    def scale_(self, value: np.ndarray) -> None:
        self._m2 = None
        self._scale = np.asarray(value, dtype=np.float64)

    def transform(self, x: np.ndarray) -> np.ndarray:
        return ((np.asarray(x) - self.mean_) / self.scale_).astype(np.float32)

    def inverse_transform(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x) * self.scale_ + self.mean_).astype(np.float32)


def feature_transform(scaler: StandardScaler, n_extra: int = 1):
    """A transform that standardizes only the scaler's own dimensions.

    Speaker-code columns are appended to the aux matrix AFTER stats were
    computed (data/generator.py ``_load_features``), so applying
    ``scaler.transform`` to the concatenated matrix raises a broadcast
    error (the reference had the same ordering bug,
    `wavenet_vocoder/bin/train.py:466-470` vs `:126-128`).  Up to
    ``n_extra`` trailing columns pass through unscaled (speaker codes
    are already one-hot/ordinal); any other width mismatch is an error —
    silently part-scaling a feature matrix from the wrong stats file
    would produce garbage audio, not a crash.
    """
    n_dims = int(np.asarray(scaler.mean_).reshape(-1).shape[0])

    def transform(h: np.ndarray) -> np.ndarray:
        h = np.asarray(h)
        if h.shape[-1] == n_dims:
            return scaler.transform(h)
        if not n_dims < h.shape[-1] <= n_dims + n_extra:
            raise ValueError(
                f"feature matrix has {h.shape[-1]} dims but the stats "
                f"cover {n_dims} (+ at most {n_extra} appended "
                f"speaker-code column(s)) — wrong --stats file?")
        return np.concatenate(
            [scaler.transform(h[..., :n_dims]),
             np.asarray(h[..., n_dims:], np.float32)], axis=-1)

    return transform
