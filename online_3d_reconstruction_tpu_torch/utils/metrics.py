"""Structured per-frame metrics + trajectory evaluation.

The reference prints ad-hoc per-stage wall-clock lines in its main loop
(SURVEY.md §2.1 C16, §5 observability). Here: a JSONL sink with per-stage
latencies and counters, plus ATE/RPE utilities against ground truth (the
synthetic oracle's poses, §4.5).
"""

from __future__ import annotations

import json
import time
from typing import IO, Dict, Optional

import numpy as np


class MetricsLogger:
    """Append per-frame metric dicts; optionally stream them to a JSONL file."""

    def __init__(self, path: str = ""):
        self.records = []
        self._file: Optional[IO] = open(path, "a") if path else None

    def log(self, record: Dict) -> None:
        self.records.append(record)
        if self._file is not None:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def auto_warmup(self) -> int:
        """Number of leading frames to skip so stage means reflect steady
        state: every frame whose summed stage time is a >3x outlier vs the
        run median contains one-time set-up (first frame, first keyframe,
        first full BA window, first downsample — scattered through the
        early run, not just frame 0); skip through the last such frame in
        the first 80% of the run."""
        totals = [
            sum(v for k, v in r.items()
                if k.startswith("t_") and isinstance(v, (int, float)))
            for r in self.records
        ]
        if len(totals) < 4:
            return 0
        med = float(np.median(totals))
        cutoff = int(0.8 * len(totals))
        outliers = [i for i, t in enumerate(totals[:cutoff]) if t > 3.0 * med]
        return max(outliers) + 1 if outliers else 0

    def summary(self, skip_first: int = 0) -> Dict:
        """Mean of every numeric field across frames.

        ``skip_first`` drops the leading warmup/compile frames so stage means
        reflect the steady state (compiles are 3 orders of magnitude larger
        than a steady frame and would otherwise dominate every mean).
        """
        out: Dict[str, float] = {}
        records = self.records[skip_first:]
        if not records:
            return out
        keys = set().union(*(r.keys() for r in records))
        for k in keys:
            vals = [r[k] for r in records if isinstance(r.get(k), (int, float))]
            if vals:
                out[k] = float(np.mean(vals))
        return out


class StageTimer:
    """Wall-clock stage timer: ``with timer.stage("sgm"): ...``."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    def stage(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                timer.times[name] = timer.times.get(name, 0.0) + (
                    time.perf_counter() - self.t0
                )

        return _Ctx()


def ate_rmse(estimated: np.ndarray, reference: np.ndarray, align: bool = False) -> float:
    """Absolute trajectory error (RMSE of translation) between (N,4,4) arrays.

    align=True first removes the best-fit rigid transform (Umeyama, no scale)
    — the standard ATE protocol when the two trajectories have independent
    gauge. Our pipeline anchors to the first prior, so align=False is the
    honest default.
    """
    est = np.asarray([p[:3, 3] for p in estimated], dtype=np.float64)
    ref = np.asarray([p[:3, 3] for p in reference], dtype=np.float64)
    assert est.shape == ref.shape
    if align:
        mu_e = est.mean(axis=0)
        mu_r = ref.mean(axis=0)
        cov = (est - mu_e).T @ (ref - mu_r)
        u, _, vt = np.linalg.svd(cov)
        d = np.sign(np.linalg.det(vt.T @ u.T))
        rot = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
        est = (est - mu_e) @ rot.T + mu_r
    return float(np.sqrt(np.mean(np.sum((est - ref) ** 2, axis=1))))


def rpe_stats(estimated: np.ndarray, reference: np.ndarray, delta: int = 1):
    """Relative pose error over ``delta``-frame steps: (trans RMSE, rot RMSE rad)."""
    t_errs, r_errs = [], []
    for i in range(len(estimated) - delta):
        rel_e = np.linalg.inv(estimated[i]) @ estimated[i + delta]
        rel_r = np.linalg.inv(reference[i]) @ reference[i + delta]
        d = np.linalg.inv(rel_r) @ rel_e
        t_errs.append(np.linalg.norm(d[:3, 3]))
        cos_t = np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        r_errs.append(np.arccos(cos_t))
    return float(np.sqrt(np.mean(np.square(t_errs)))), float(
        np.sqrt(np.mean(np.square(r_errs)))
    )
