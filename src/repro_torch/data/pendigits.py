"""Pen-based handwritten digit surrogate dataset (paper Section VII), a numpy
copy of ``repro/data/pendigits.py`` that gives its arrays exactly.

The paper uses UCI pendigits [40]: 16 integer features (8 resampled (x, y)
pen points, scaled to [0, 100]), 10 classes, 7494 train / 3498 test.  This
container is offline, so we synthesize a *deterministic surrogate* with the
same cardinalities: each digit class is a parametric pen trajectory (built
from digit-like stroke control points), resampled at 8 points, jittered with
per-sample noise, affine-perturbed (scale/rotation/translation, as real
handwriting varies), then quantized to the [0, 100] integer grid.

DESIGN.md 6 records this deviation; every paper claim we validate is relative
(accuracy deltas, tnzd reduction), not an absolute pendigits score.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

N_FEATURES = 16
N_CLASSES = 10
N_TRAIN = 7494
N_TEST = 3498

# Control points (x, y) in [0,1]^2 sketching each digit's pen stroke.
_STROKES = {
    0: [(.5, .9), (.2, .7), (.2, .3), (.5, .1), (.8, .3), (.8, .7), (.5, .9)],
    1: [(.35, .7), (.55, .9), (.55, .1)],
    2: [(.2, .7), (.5, .9), (.8, .7), (.5, .45), (.2, .1), (.8, .1)],
    3: [(.2, .85), (.7, .9), (.45, .55), (.8, .3), (.5, .1), (.2, .2)],
    4: [(.65, .1), (.65, .9), (.2, .35), (.85, .35)],
    5: [(.8, .9), (.25, .9), (.22, .5), (.6, .55), (.8, .3), (.5, .1), (.2, .2)],
    6: [(.7, .9), (.3, .6), (.25, .25), (.55, .1), (.75, .3), (.5, .45), (.3, .35)],
    7: [(.2, .9), (.8, .9), (.45, .4), (.35, .1)],
    8: [(.5, .5), (.25, .7), (.5, .9), (.75, .7), (.25, .3), (.5, .1), (.75, .3), (.5, .5)],
    9: [(.7, .6), (.45, .75), (.3, .55), (.55, .45), (.7, .65), (.65, .2)],
}


def _resample(points: np.ndarray, n: int) -> np.ndarray:
    """Arc-length resample a polyline to n points (as the UCI set was built)."""
    seg = np.linalg.norm(np.diff(points, axis=0), axis=1)
    t = np.concatenate([[0.0], np.cumsum(seg)])
    t = t / t[-1]
    ts = np.linspace(0.0, 1.0, n)
    out = np.empty((n, 2))
    for d in range(2):
        out[:, d] = np.interp(ts, t, points[:, d])
    return out


@dataclass
class Pendigits:
    x_train: np.ndarray   # (N_TRAIN, 16) int in [0, 100]
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray

    def validation_split(self, frac: float = 0.30, seed: int = 7):
        """Move ``frac`` of the training set to a validation set (paper IV-A)."""
        rng = np.random.default_rng(seed)
        n = self.x_train.shape[0]
        idx = rng.permutation(n)
        n_val = int(round(frac * n))
        val, tr = idx[:n_val], idx[n_val:]
        return ((self.x_train[tr], self.y_train[tr]),
                (self.x_train[val], self.y_train[val]))


def _generate(n: int, rng: np.random.Generator, noise: float):
    x = np.empty((n, N_FEATURES), dtype=np.int64)
    y = rng.integers(0, N_CLASSES, size=n)
    protos = {c: _resample(np.asarray(_STROKES[c], dtype=np.float64), 8)
              for c in range(N_CLASSES)}
    for i in range(n):
        pts = protos[int(y[i])].copy()
        # affine jitter: rotation, anisotropic scale, translation
        th = rng.normal(0.0, 0.12)
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        scale = 1.0 + rng.normal(0.0, 0.10, size=2)
        center = pts.mean(axis=0)
        pts = (pts - center) * scale @ rot.T + center
        pts += rng.normal(0.0, 0.035, size=2)        # translation
        pts += rng.normal(0.0, noise, size=pts.shape)  # per-point tremor
        x[i] = np.clip(np.round(pts.ravel() * 100), 0, 100).astype(np.int64)
    return x, y


def load(seed: int = 0, noise: float = 0.14) -> Pendigits:
    # noise=0.14 calibrates the surrogate so float accuracies land in the
    # paper's Table I regime (16-10 ~ 89%, 16-16-10 ~ 95%).
    rng = np.random.default_rng(seed)
    x_tr, y_tr = _generate(N_TRAIN, rng, noise)
    x_te, y_te = _generate(N_TEST, rng, noise)
    return Pendigits(x_tr, y_tr, x_te, y_te)


def to_unit(x_int: np.ndarray) -> np.ndarray:
    """Map [0,100] integer features to the [-1, 1) activation domain."""
    return (x_int.astype(np.float64) / 100.0) * 2.0 - 1.0
