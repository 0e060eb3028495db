"""Device time of one kernel launch, with CUDA events.

A trial queues LAUNCHES_PER_TRIAL launches behind a device-side sleep, so that
the host's cost of enqueueing them stays out of the span that the events
time; the launches take their inputs in turn from copies that together
hold more than the card's L2, so each launch reads its input from device
memory.
"""

from __future__ import annotations

import statistics

import torch

TRIALS = 15
LAUNCHES_PER_TRIAL = 20
SLEEP_CYCLES = 50_000_000  # ~25 ms: longer than enqueueing a trial's launches
# 4x the H100's 50 MB L2: cycling through copies this large, no launch
# finds its input in what the launch before left in L2.
ROTATE_BYTES = 200_000_000


def rotated(x: torch.Tensor) -> list[torch.Tensor]:
    """Copies of x that together hold at least ROTATE_BYTES."""
    return [x.clone() for _ in range(-(-ROTATE_BYTES // x.nbytes))]


def median_ms(fn, xs, n) -> float:
    """Median device time in ms of one call ``fn(x, n)``, the calls taking
    the inputs xs in turn (CUDA tensors)."""
    fn(xs[0], n)
    torch.cuda.synchronize()
    times = []
    launch = 0
    for _ in range(TRIALS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(LAUNCHES_PER_TRIAL):
            fn(xs[launch % len(xs)], n)
            launch += 1
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / LAUNCHES_PER_TRIAL)
    return statistics.median(times)


def in_turns(fa, fb, xs_a, xs_b, n) -> tuple[float, float]:
    """Median device times in ms of ``fa`` and ``fb``, timed in turns a, b,
    b, a (each on its own inputs), each the mean of its two medians."""
    a1 = median_ms(fa, xs_a, n)
    b1 = median_ms(fb, xs_b, n)
    b2 = median_ms(fb, xs_b, n)
    a2 = median_ms(fa, xs_a, n)
    return (a1 + a2) / 2, (b1 + b2) / 2
