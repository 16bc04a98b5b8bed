"""What the port's bench scripts share: the card line, the mainnet setup's
path, seeded canonical scalars made with numpy, and the timers (CUDA
events for device time; the host clock between two synchronizes for wall
time)."""

import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..constants import R_MOD
from ..ops.field import FR, ints_to_limbs

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SETUP_PATH = os.path.join(REPO, "tests", "trusted_setup.txt")
_R_LIMBS = ints_to_limbs([R_MOD], FR.n_limbs)[:, 0]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def require_card(name: str) -> bool:
    """True with a card; without one, says so on stderr (the scripts then
    exit non-zero: no number of theirs comes from the CPU)."""
    if torch.cuda.is_available():
        return True
    print(f"{name}: no CUDA device", file=sys.stderr)
    return False


def random_scalars(rng: np.random.Generator, count: int) -> np.ndarray:
    """(16, count) int32 limbs of scalars uniform in [0, r): 255-bit draws,
    the ones >= r drawn again."""
    limbs = np.empty((count, FR.n_limbs), dtype=np.int64)
    todo = np.arange(count)
    while todo.size:
        draw = rng.integers(0, 1 << 16, (todo.size, FR.n_limbs), dtype=np.int64)
        draw[:, -1] &= 0x7FFF
        lt = np.zeros(todo.size, dtype=bool)
        eq = np.ones(todo.size, dtype=bool)
        for i in range(FR.n_limbs - 1, -1, -1):
            lt |= eq & (draw[:, i] < _R_LIMBS[i])
            eq &= draw[:, i] == _R_LIMBS[i]
        limbs[todo[lt]] = draw[lt]
        todo = todo[~lt]
    return np.ascontiguousarray(limbs.T.astype(np.int32))


def device_ms(fn, reps: int, queue_ahead: bool = False) -> float:
    """Mean device time of fn over `reps` runs (CUDA events), after one
    warm run. With `queue_ahead`, the stream first spins for about 5 ms so
    that the host queues all `reps` launches before the first one starts:
    a kernel shorter than its wrapper's host overhead (tens of
    microseconds) is then timed back to back, not at the host's launch
    rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda._sleep(10_000_000)  # GPU clock cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_s(fn):
    """(result, seconds) of fn between two synchronizes of the device."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0
