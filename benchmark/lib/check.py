"""The comparisons that decide ``correct``, and how they are reported.

Every number compared has a limit of its own, stated in the configuration's
file under ``limits``.  A run is correct when no number exceeds its limit
and nothing that was due is missing.  The numbers and limits are printed as
the last lines of standard error and under the result's last key.
"""

from __future__ import annotations

import sys
from typing import Dict, Sequence, Tuple

import numpy as np


def frame_gaps(program: Sequence[np.ndarray], reference: Sequence[np.ndarray]
               ) -> np.ndarray:
    """Mean |program - reference| of each uint8 frame, in counts."""
    if len(program) != len(reference):
        raise ValueError(f"{len(program)} frames against "
                         f"{len(reference)} reference frames")
    return np.array([np.abs(p.astype(np.int16) - r.astype(np.int16)).mean()
                     if p.shape == r.shape else np.inf
                     for p, r in zip(program, reference)], np.float64)


def gap_readings(gaps: np.ndarray) -> Dict[str, float]:
    """The inference cells' numbers: the mean gap over every compared value
    (frames are of one size) and the worst frame's mean gap, in uint8
    counts."""
    if gaps.size == 0:
        return {"mean_abs_counts": float("inf"),
                "worst_frame_mean_abs_counts": float("inf")}
    return {"mean_abs_counts": float(gaps.mean()),
            "worst_frame_mean_abs_counts": float(gaps.max())}


def judge(readings: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every reading within its limit, {name: {value, limit}})."""
    compared = {}
    ok = True
    for name, limit in limits.items():
        value = readings.get(name, float("nan"))
        compared[name] = {"value": value, "limit": limit}
        if not value <= limit:  # NaN fails
            ok = False
    return ok, compared


def report(compared: Dict[str, Dict[str, float]]) -> None:
    """The numbers compared beside their limits, as the last lines of
    standard error."""
    for name, v in compared.items():
        print(f"compared {name} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
