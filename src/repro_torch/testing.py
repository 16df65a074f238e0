"""Helpers shared by the port's tests and ``chip_smoke.py``.

run_world  run a function on a world of rank processes and join them
           within a deadline (a failed rank raises, every rank is killed on
           time-out)
nans       quiet NaNs of both signs of a float dtype, bit for bit
"""
from __future__ import annotations

import time

import torch

# quiet NaNs of both signs, as raw bits
NAN_BITS = {torch.float32: (0x7FC00000, -0x00400000),
            torch.bfloat16: (0x7FC0, -0x40),
            torch.float64: (0x7FF8000000000000, -0x0008000000000000)}


def nans(dtype, device="cpu") -> torch.Tensor:
    """(+NaN, -NaN) of a float dtype on ``device``, bit for bit."""
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[dtype.itemsize]
    return torch.tensor(NAN_BITS[dtype], dtype=view).view(dtype).to(device)


def run_world(fn, world: int, args: tuple, deadline: float) -> None:
    """Spawn ``fn(rank, world, *args)`` on ``world`` processes and join them
    by ``deadline`` (a ``time.monotonic()`` time): a failed rank raises, and
    on time-out ``TimeoutError`` is raised; every rank still alive is
    killed either way."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=(world, *args), nprocs=world,
                             join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{fn.__name__}: the world of {world} "
                                   f"ranks did not finish in time")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(5)
