"""The device an entry point of the port runs on, and the CPU's threads."""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

# The intra-op threads a CPU run sums with.  A float sum split over
# threads adds in an order that follows their count, and MKL and OpenMP
# may pick that count by the host's load: one thread makes every sum's
# order, and so every bitwise contract (resume == uninterrupted, chunked
# == stepwise), hold whatever the host runs beside.
CPU_THREADS = 1


def resolve_device(device: Optional[str]) -> torch.device:
    """The run's device: CUDA unless the caller names another.  Raises
    when CUDA is asked for (or defaulted to) and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev


@contextlib.contextmanager
def pinned_cpu_threads(device: torch.device) -> Iterator[None]:
    """On a CPU device, run the block with `CPU_THREADS` intra-op threads
    and give the caller its own count back after it; on any other device
    change nothing."""
    if device.type != "cpu":
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(CPU_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(before)
