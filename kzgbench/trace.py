"""The traced calls: a few calls under torch.profiler (CPU and CUDA
activities), reduced to what the per-layer readers and the breakdown need.

The arithmetic is that of the port's `trace_main_path._trace` (kernel
count, kernel time, busy share of the wall, top kernels), with two
changes: the busy time is the union of the device's intervals, not their
sum (the same on one stream, and right on several), and each idle gap
between them is named by the innermost host operation active at its
middle, so the breakdown says what the host was doing while the card
waited.
"""

import time
from collections import defaultdict
from dataclasses import dataclass, field

from . import stats

_COPY_PREFIXES = ("Memcpy", "Memset")
_RUNTIME_PREFIXES = ("cuda", "cu")  # driver and runtime API calls: launches, not the host's work
NO_OP = "host code outside torch ops"


@dataclass
class Trace:
    calls: int
    wall_s: float  # the traced calls' wall, host clock
    kernels: int  # CUDA kernel events (copies and memsets left out)
    kernel_s: float  # summed kernel durations
    busy_s: float  # union of every device interval (kernels and copies)
    device_ops: list = field(default_factory=list)  # [name, seconds], most time first
    idle_gaps: list = field(default_factory=list)  # [host op, idle seconds], most first


def _events(prof):
    """(name, is_device, start_ns, end_ns, thread) of every profiler event,
    from the raw Kineto events: building the FunctionEvent tree of 10^5-10^6
    events (`prof.events()`) takes minutes."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        yield e.name(), e.device_type() == cuda, e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id()


def _name_gaps(gap_list, host_ops) -> dict:
    """Idle seconds by the innermost host op whose interval holds each
    gap's middle (host ops of one thread nest)."""
    host_ops.sort(key=lambda e: (e[1], -e[2]))
    totals = defaultdict(float)
    stack, i = [], 0
    for a, b in sorted(gap_list):
        mid = (a + b) / 2
        while i < len(host_ops) and host_ops[i][1] <= mid:
            stack.append(host_ops[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        inner = next((e for e in reversed(stack) if e[1] <= mid <= e[2]), None)
        totals[inner[0] if inner else NO_OP] += (b - a) / 1e9
    return totals


def traced(calls, top: int = 10) -> Trace:
    """Run each zero-argument callable in `calls` under the profiler, with
    a synchronize at the end, and reduce the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        t0 = time.perf_counter()
        for fn in calls:
            fn()
        sync()
        wall = time.perf_counter() - t0
    device, host, kernels, kernel_ns = [], defaultdict(list), 0, 0
    by_name = defaultdict(int)
    for name, on_device, start, end, thread in _events(prof):
        if on_device:
            device.append((start, end))
            if not name.startswith(_COPY_PREFIXES):
                kernels += 1
                kernel_ns += end - start
            by_name[name] += end - start
        elif not name.startswith(_RUNTIME_PREFIXES) and end > start:
            host[thread].append((name, start, end))
    merged = stats.union(device)
    busy_ns = sum(b - a for a, b in merged)
    # the window in the profiler's clock: from the first host op to the last event
    first = min([a for a, _ in merged[:1]] + [e[1] for ops in host.values() for e in ops] or [0])
    last = max([b for _, b in merged[-1:]] + [e[2] for ops in host.values() for e in ops] or [first])
    main = max(host.values(), key=len) if host else []
    idle = _name_gaps(stats.gaps(merged, first, last), list(main))
    return Trace(
        calls=len(calls),
        wall_s=wall,
        kernels=kernels,
        kernel_s=kernel_ns / 1e9,
        busy_s=busy_ns / 1e9,
        device_ops=[[n, t / 1e9] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[n, t] for n, t in sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
    )
