"""Labeled/unlabeled pool bookkeeping for pool-based active learning
(``repro.core.pool`` ported; numpy only, so a seed gives the reference's
windows draw for draw).

The paper subsamples a 200-image window from the device's unlabeled data at
every acquisition iteration "in order to reduce the computing cost as all
the data in the pool are being measured" — ``draw_window`` reproduces that.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class ActivePool:
    """Index-space pool over a device's local dataset."""
    n_total: int
    labeled: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    rng: np.random.Generator = field(default_factory=np.random.default_rng)

    @classmethod
    def create(cls, n_total: int, *, initial_labeled=None, seed: int = 0):
        pool = cls(n_total=n_total, rng=np.random.default_rng(seed))
        if initial_labeled is not None:
            pool.labeled = np.asarray(initial_labeled, dtype=np.int64)
        return pool

    @property
    def unlabeled(self) -> np.ndarray:
        mask = np.ones(self.n_total, dtype=bool)
        mask[self.labeled] = False
        return np.nonzero(mask)[0]

    def draw_window(self, window: int = 200) -> np.ndarray:
        """Random subsample of the unlabeled pool to score this iteration."""
        unl = self.unlabeled
        if len(unl) <= window:
            return unl
        return self.rng.choice(unl, size=window, replace=False)

    def acquire(self, window_indices: np.ndarray, selected_in_window: np.ndarray) -> np.ndarray:
        """Mark ``window_indices[selected_in_window]`` as labeled; returns the
        indices that were NEWLY labeled.

        Deduplicated both within the selection and against the existing
        labeled set: a repeated index used to be appended again, double-
        counting it in ``len(labeled)`` — the n_i that weights Eq. 1
        (``fedavg_n``) — and double-sampling it in the training gather.
        """
        picked = np.unique(
            np.asarray(window_indices)[np.asarray(selected_in_window)]
            .astype(np.int64))
        new = np.setdiff1d(picked, self.labeled)
        self.labeled = np.concatenate([self.labeled, new])
        return new
