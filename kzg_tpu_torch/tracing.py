"""The package's one tracing module: named spans and plain counters.

Counters (`count`) are always on: plain integers, keyed by name. The eight
hand-written kernels' launches are counters `launch.<kernel>`: each
wrapper is registered with `counted` and counts where it launches its
kernel, and nowhere else; `launches()` reads those counts alone and
`reset_launches()` zeroes them (also as `ops.launch.*`). Other counters:
`field.inversions`, one a Fermat inversion (`ops/field.py inv`, a batch);
`recover.passes`, one a recovery body (`eip7594._recover_body`, a chunk of
blobs), and `recover.blobs`, the blobs it recovered (those given all 128
cells left out); `msm.small`, the variable-base MSMs of fewer than 8
points (`ops/msm.py msm`, one a row of the batch).

Spans (`span`) record exactly while a torch.profiler session is active
(`torch.autograd.profiler._is_profiler_enabled`); otherwise a span is one
boolean check. A recording span
  - enters a `_RecordFunctionFast` range of its name, so the profiler's
    trace carries it as a host `cpu_op`. (A `record_function` range is a
    user annotation, to which the profiler adds a device-side twin,
    `gpu_user_annotation`, that a reader of CUDA events takes for a
    kernel);
  - appends a record (`Span`) to an in-memory list, `spans()`: its name,
    its start and end on `time.time_ns()` (the clock of the profiler's
    events), its parent and the id of the API call it belongs to.
A span named `kzg.api.*` outside any API call opens one: every span inside
it carries its id, and its record carries the change of every counter
over its interval. Nothing is written to files: the profiler's own
exporter (`export_chrome_trace`) carries the spans.

The names, all under `kzg.` (families partition an API call's time):
  kzg.api.<function>         api.py, each public function: the call
  kzg.body.<name>            the protocol bodies (eip4844.py, eip7594.py);
                             kzg.body.vanish, the vanishing polynomials
                             inside kzg.body.recover
  kzg.msm.fixed, .var        ops/msm.py; stages .scan (B1 and the
                             segmented scan), .integrate (bucket
                             integration, B9), .combine (B3)
  kzg.g1fft                  ops/g1fft.py: G1 FFTs and FK20's ladders
  kzg.ntt                    ops/fft.py: the Fr NTTs (B4, B5)
  kzg.inv                    ops/field.py inv: a Fermat inversion
  kzg.native.<function>      native.py, each call into the host core
  kzg.wait                   the host blocked on the card: a read back
                             or a copy from host memory (PyTorch
                             synchronizes the stream after each)
  kzg.settings.*, kzg.table.<name>.build / .load
                             settings, tables and the kernel libraries
"""

import functools
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

API = "kzg.api."
WAIT = "kzg.wait"


class Span(NamedTuple):
    name: str
    start_ns: int  # time.time_ns()
    end_ns: int  # 0 while the span is open
    parent: int  # index in spans() of the enclosing span, -1 for none
    call: int  # id of the API call the span belongs to, 0 outside any
    counts: Optional[dict]  # an API call's counter changes; None for other spans


_counters: Dict[str, int] = {}
_records: list = []  # [name, start_ns, end_ns, parent, call, counts], in start order
_lock = threading.Lock()
_local = threading.local()
_call_ids = itertools.count(1)
LAUNCHES = {}  # kernel name -> its wrapper


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------


def count(name: str, n: int = 1) -> None:
    _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    return dict(_counters)


def counted(name: str):
    """Register a kernel wrapper under `name`, its launch count at 0."""

    def register(fn):
        LAUNCHES[name] = fn
        _counters["launch." + name] = 0
        return fn

    return register


def launches() -> dict:
    return {name: _counters["launch." + name] for name in LAUNCHES}


def reset_launches() -> None:
    for name in LAUNCHES:
        _counters["launch." + name] = 0


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _begin(name: str):
    stack = _stack()
    parent = stack[-1][1] if stack else -1
    call = stack[-1][0][4] if stack else 0
    counts = None
    if call == 0 and name.startswith(API):
        call, counts = next(_call_ids), dict(_counters)
    rf = _RecordFunctionFast(name)
    rf.__enter__()
    rec = [name, time.time_ns(), 0, parent, call, counts]
    with _lock:
        index = len(_records)
        _records.append(rec)
    stack.append((rec, index))
    return rf, rec


def _end(opened) -> None:
    rf, rec = opened
    rec[2] = time.time_ns()
    before = rec[5]
    if before is not None:
        rec[5] = {k: v - before.get(k, 0) for k, v in _counters.items() if v != before.get(k, 0)}
    _stack().pop()
    rf.__exit__(None, None, None)


class span:
    """A named span: `with span(name):` (a fresh object each time) or
    `@span(name)` on a function."""

    __slots__ = ("name", "_open")

    def __init__(self, name: str):
        self.name = name
        self._open = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._open = _begin(self.name)
        return self

    def __exit__(self, *exc):
        if self._open is not None:
            _end(self._open)
            self._open = None
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            opened = _begin(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _end(opened)

        return wrapped


def spans() -> List[Span]:
    """Every span recorded since the last reset(), in start order."""
    with _lock:
        return [Span(*r) for r in _records]


def reset() -> None:
    """Forget the recorded spans and zero every counter (outside any span)."""
    with _lock:
        _records.clear()
    for k in _counters:
        _counters[k] = 0
