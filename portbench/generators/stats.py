"""The standardization the enhancement path applies, with the reference's
rule (utils/standardization_utils.py:37-59): the mean per channel over time
and windows; the standard deviation of a 'wh' block per channel (the spread
of each window's own over the windows, + 1e-10), of any other block one
number over the whole array."""

from __future__ import annotations

import numpy as np


def _std(feat, a):
    if feat == "wh":
        return a.std(axis=1).std(axis=0) + 1e-10
    return a.std()


class Standardization:
    def __init__(self, X, Y, pipeline):
        in_feat, out_feat = pipeline.split("2")
        self.mean_x, self.std_x = X.mean(axis=1).mean(axis=0), _std(in_feat, X)
        self.mean_y, self.std_y = Y.mean(axis=1).mean(axis=0), _std(out_feat, Y)

    def apply(self, X):
        return ((X - self.mean_x) / self.std_x).astype(np.float32)

    def restore(self, Y):
        return (Y * self.std_y + self.mean_y).astype(np.float32)
