"""Named phase spans and step counters on ``torch.profiler``'s clock.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler records in this process, and one shared null context otherwise:
no setting turns the spans on, a profiler does (``SLAMRunner._profiled_step``,
or any ``torch.profiler.profile`` round ``step``).  The ranges land in the
profiler's Chrome trace beside the CUDA runtime, kernel and copy events,
on the same clock.  With no profiler running a span costs a flag check and
an empty ``with`` (under a microsecond on one CPU core, where a
``record_function`` that records nothing takes over ten).  ``add_counters``
writes a JSON object at the root of the exported trace under its key,
while a profiler records.
"""
from __future__ import annotations

import contextlib
import json
from typing import Dict

import torch

_OFF = contextlib.nullcontext()


def recording() -> bool:
    """True while a ``torch.profiler`` records in this process."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records,
    else a null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def add_counters(key: str, counters: Dict[str, float]) -> None:
    """``counters`` as a JSON object under ``key`` at the root of the trace
    the recording profiler exports (nothing when none records)."""
    if torch.autograd._profiler_enabled():
        torch.autograd._add_metadata_json(key, json.dumps(counters))
