"""Divergence sentinel (the JAX package's ``resilience/sentinel.py``): so
far only the host-side check the serving engine runs per decode row. The
in-step guard of the trainers waits for ROADMAP A6."""

from __future__ import annotations

import numpy as np
import torch


def host_nonfinite(arr) -> bool:
    """True when ``arr`` (a numpy array or a tensor on any device) carries
    any NaN/Inf. The serving edge uses it to refuse to ship garbage
    predictions (counted as ``serving_nonfinite_outputs_total`` by the
    caller)."""
    if isinstance(arr, torch.Tensor):
        return not bool(torch.isfinite(arr).all())
    return not bool(np.isfinite(np.asarray(arr)).all())
