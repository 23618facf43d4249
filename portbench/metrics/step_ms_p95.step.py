"""Classifier engine (``classify_slide``): the 95th percentile of the host
milliseconds between successive fetches of a batch's probabilities."""

import numpy as np


def read(run, ctx):
    gaps = np.diff(run["fetches"])
    return float(np.percentile(gaps, 95)) * 1e3 if len(gaps) >= 20 else None
