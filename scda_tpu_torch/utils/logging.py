"""Structured training metrics: JSONL stdout/file + optional TensorBoard.

Rebuild of the reference's observability (SURVEY.md §5): ``print`` of the
four losses every ``disp_interval`` + optional tensorboardX scalars behind
``--use_tfb``.  Here every step's metrics dict is emitted as one JSON line
(machine-parseable) and mirrored to TensorBoard via ``tf.summary`` when
requested.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Mapping, Optional, TextIO


def _to_float(v: Any) -> Any:
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


class MetricsLogger:
    def __init__(
        self,
        log_file: Optional[str] = None,
        tensorboard_dir: Optional[str] = None,
        stream: TextIO = sys.stdout,
    ):
        self.stream = stream
        if log_file:
            import os

            os.makedirs(os.path.dirname(os.path.abspath(log_file)),
                        exist_ok=True)
            self._file = open(log_file, "a")
        else:
            self._file = None
        self._tb = None
        if tensorboard_dir:
            try:
                import tensorflow as tf

                self._tb = tf.summary.create_file_writer(tensorboard_dir)
            except Exception as e:  # pragma: no cover - tf optional
                print(f"[logging] tensorboard disabled: {e}",
                      file=sys.stderr)
        self._t0 = time.perf_counter()

    def log(self, step: int, metrics: Mapping[str, Any],
            prefix: str = "train") -> None:
        payload: Dict[str, Any] = {
            "step": int(step),
            "wall_s": round(time.perf_counter() - self._t0, 3),
        }
        payload.update({k: _to_float(v) for k, v in metrics.items()})
        line = json.dumps({prefix: payload})
        print(line, file=self.stream, flush=True)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._tb is not None:
            import tensorflow as tf

            with self._tb.as_default():
                for k, v in payload.items():
                    if isinstance(v, float):
                        tf.summary.scalar(f"{prefix}/{k}", v, step=step)

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._tb is not None:
            self._tb.close()


class StepTimer:
    """Per-step wall-clock timing with warmup-excluded averages
    (the benchmark harness the reference lacked)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times = []
        self._last = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._last
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        t = self.times[self.warmup:] or self.times
        return sum(t) / max(len(t), 1)

    def images_per_sec(self, batch_size: int) -> float:
        return batch_size / self.mean if self.times else 0.0
