"""Reconstruction quality metrics: accuracy / completeness (DTU protocol).

BASELINE.md's north-star metric is "DTU accuracy/completeness (mm) parity":
  * accuracy: distances from reconstructed points to the ground-truth
    surface/cloud (how correct is what we produced);
  * completeness: distances from ground-truth samples to the reconstruction
    (how much of the true surface we covered).
Both are reported as mean/median plus the fraction under a threshold.
Nearest neighbors via scipy's cKDTree (host; metric computation is not a
hot path).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CloudMetrics", "accuracy_completeness"]


@dataclasses.dataclass
class CloudMetrics:
    accuracy_mean: float
    accuracy_median: float
    completeness_mean: float
    completeness_median: float
    accuracy_frac_under: float
    completeness_frac_under: float
    threshold: float

    def summary(self) -> str:
        return (
            f"acc mean/med {self.accuracy_mean:.4f}/{self.accuracy_median:.4f} "
            f"comp mean/med {self.completeness_mean:.4f}/"
            f"{self.completeness_median:.4f} "
            f"(<{self.threshold}: acc {self.accuracy_frac_under:.1%} "
            f"comp {self.completeness_frac_under:.1%})"
        )


def accuracy_completeness(
    cloud: np.ndarray,
    gt: np.ndarray,
    threshold: float = 0.02,
    max_dist: float | None = None,
) -> CloudMetrics:
    """cloud, gt: (N, 3)/(M, 3). max_dist clips outlier distances (DTU uses
    20mm) so a few floaters don't dominate the means."""
    from scipy.spatial import cKDTree

    cloud = np.asarray(cloud, np.float64)
    gt = np.asarray(gt, np.float64)
    if len(cloud) == 0 or len(gt) == 0:
        nan = float("nan")
        return CloudMetrics(nan, nan, nan, nan, 0.0, 0.0, threshold)
    d_acc, _ = cKDTree(gt).query(cloud)
    d_comp, _ = cKDTree(cloud).query(gt)
    if max_dist is not None:
        d_acc = np.minimum(d_acc, max_dist)
        d_comp = np.minimum(d_comp, max_dist)
    return CloudMetrics(
        accuracy_mean=float(d_acc.mean()),
        accuracy_median=float(np.median(d_acc)),
        completeness_mean=float(d_comp.mean()),
        completeness_median=float(np.median(d_comp)),
        accuracy_frac_under=float((d_acc < threshold).mean()),
        completeness_frac_under=float((d_comp < threshold).mean()),
        threshold=threshold,
    )
