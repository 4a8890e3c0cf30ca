"""The lean host path from a kernel's wrapper to its C entry point.

A wrapper declares its C function once, as an ``Entry``, and launches it
with ``launch(entry, name, device_index, *args)``: the operands' raw
pointers and sizes as Python ints (0 for a null pointer), to which
``launch`` appends the raw handle of the current CUDA stream of that
device. The arguments travel as one block of 64-bit slots (``struct``),
one bytes argument that ctypes hands to C as a pointer, instead of one
``argtypes`` conversion per argument; the C entry copies the block out and
casts each slot back. ``launch`` reads the stream handle with
``torch._C._cuda_getCurrentRawStream`` (no ``torch.cuda.Stream`` object),
enters a ``torch.cuda.device`` context only when the operands lie on
another device than the current one, and raises when the C function
returns a CUDA error. Nothing is built or loaded until the first launch.
The operand checks stay in each wrapper. ``device_launches`` counts, for
checks and measurements, the device launches of one call
(``device_kernels``: by kernel name).
"""

from __future__ import annotations

import ctypes
import struct
from collections import Counter

import torch


class Entry:
    """One C function ``int symbol(const int64_t* args)`` of a kernel
    library (``csrc/<source>``), which takes ``nargs`` slots and the stream
    after them: built and loaded at its first use. ``lib`` is the loaded
    library, for the wrapper's other C functions."""

    __slots__ = ("source", "symbol", "pack", "fn", "lib")

    def __init__(self, source: str, symbol: str, nargs: int) -> None:
        self.source, self.symbol = source, symbol
        self.pack = struct.Struct(f"={nargs + 1}q").pack
        self.fn = self.lib = None

    def load(self):
        if self.fn is None:
            from videoquery_torch.kernels import _build

            lib = _build.load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes, fn.restype = [ctypes.c_char_p], ctypes.c_int
            self.lib, self.fn = lib, fn
        return self.fn


def launch(entry: Entry, name: str, device: int, *args: int) -> None:
    """Call ``entry`` with ``args`` and the current stream of CUDA device
    ``device``; raise RuntimeError if it returns a CUDA error."""
    fn = entry.fn or entry.load()
    if torch._C._cuda_getDevice() == device:
        err = fn(entry.pack(*args, torch._C._cuda_getCurrentRawStream(device)))
    else:
        with torch.cuda.device(device):
            err = fn(entry.pack(*args, torch._C._cuda_getCurrentRawStream(device)))
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _traced_kernels(fn) -> Counter:
    """{device kernel or memset name: launches} in one torch.profiler trace
    of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return Counter(e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)


def device_launches(fn, attempts: int = 3) -> int:
    """Device launches (kernels and memsets) of one call of ``fn``: the most
    that ``attempts`` torch.profiler traces of it show. A trace now and then
    misses device activity (seen on an H100: a 0.5 ms K2 call with none at
    all, a three-launch T1 call with two), and a missed launch only lowers
    the count."""
    return max(sum(_traced_kernels(fn).values()) for _ in range(attempts))


def device_kernels(fn, attempts: int = 3) -> Counter:
    """{name: device launches} of one call of ``fn``, per name the most that
    ``attempts`` torch.profiler traces show (as ``device_launches``)."""
    out: Counter = Counter()
    for _ in range(attempts):
        out |= _traced_kernels(fn)
    return out
