#
# Host-side utilities of the PyTorch port (the counterpart of the JAX package's utils).
#

from __future__ import annotations

import logging
import sys
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Union

import torch

_LOG_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def get_logger(cls: Any, level: Union[int, str] = logging.INFO) -> logging.Logger:
    """Per-class logger (reference utils.py:555-576)."""
    name = cls if isinstance(cls, str) else getattr(cls, "__name__", str(cls))
    logger = logging.getLogger(f"spark_rapids_ml_torch.{name}")
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_LOG_FORMAT))
        logger.addHandler(handler)
        logger.propagate = False
    return logger


class SpanTimes(dict):
    """{stage: seconds} of record_spans(), and in `attrs` the attributes each
    stage's last span was opened with ({stage: {name: value}})."""

    def __init__(self) -> None:
        super().__init__()
        self.attrs: Dict[str, Dict[str, Any]] = {}


# Stage timings: None while nothing records, else the dict record_spans() fills.
_spans: Optional[SpanTimes] = None
# seconds of the spans closed inside each open span, innermost last
_open: List[float] = []


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def span(name: str, **attrs: Any) -> Iterator[None]:
    """Wall seconds of one stage of a fit or transform, added under `name` to the
    dict that record_spans() is filling; `attrs` (such as the form a kNN search
    ran in) are kept in its `attrs`. The card is synchronized at both ends,
    so the device work a stage queued is charged to that stage. A span opened
    inside another is charged to itself only (the outer one records its time
    less the inner one's), so the stages of one call stay disjoint. While
    nothing records, a span costs one global read and changes nothing."""
    if _spans is None:
        yield
        return
    if attrs:
        _spans.attrs[name] = dict(attrs)
    _sync()
    t0 = time.perf_counter()
    _open.append(0.0)
    try:
        yield
    finally:
        _sync()
        elapsed = time.perf_counter() - t0
        inner = _open.pop()
        _spans[name] = _spans.get(name, 0.0) + elapsed - inner
        if _open:
            _open[-1] += elapsed


@contextmanager
def record_spans() -> Iterator[SpanTimes]:
    """Collect the spans of the calls made inside the block:
    `with record_spans() as t: model = PCA(k=3).fit(X)` leaves {stage: seconds}
    in t (and the spans' attributes in t.attrs); the stages of one call are
    disjoint."""
    global _spans
    prev, _spans = _spans, SpanTimes()
    try:
        yield _spans
    finally:
        _spans = prev
