"""Logging + per-stage timers/counters for one pipeline run."""
from __future__ import annotations

import contextlib
import logging
import time

from torch.profiler import record_function

log = logging.getLogger("densepoints_tpu_torch")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    )
    log.addHandler(_h)
    log.setLevel(logging.INFO)


class StageMetrics:
    """Accumulates per-stage wall times and counters for one pipeline run.

    `sync`, when given, is called before each clock read (e.g.
    `torch.cuda.synchronize`), so a stage's time covers its device work and
    not only the host's enqueue. A stage is also a profiler span,
    `stage/<name>`, around its timer and syncs."""

    def __init__(self, sync=None):
        self.times: dict[str, float] = {}
        self.counters: dict[str, float] = {}
        self._sync = sync or (lambda: None)

    @contextlib.contextmanager
    def stage(self, name: str):
        with record_function(f"stage/{name}"):
            self._sync()
            start = time.perf_counter()
            try:
                yield
            finally:
                self._sync()
                self.times[name] = self.times.get(name, 0.0) + (
                    time.perf_counter() - start
                )

    def count(self, name: str, value: float):
        self.counters[name] = value

    def summary(self) -> str:
        parts = [f"{k}={v:.3f}s" for k, v in self.times.items()]
        parts += [f"{k}={v:g}" for k, v in self.counters.items()]
        return " ".join(parts)
