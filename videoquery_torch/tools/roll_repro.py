"""The dynamic-shift roll check, the port's counterpart of
``tools/mosaic_roll_repro.py``.

The TPU repro showed that ``pltpu.roll`` by a negative dynamic shift along
axis 0 corrupted data on one TPU stack. This runs the same 12 cases through
the port's roll kernel (T2, ``kernels/roll.py``): an f32 [1, 80, 256] tile
from ``np.random.default_rng(0)``, axis 0 and 1, both signs, shifts 1, 5 and
8, each shift an int32 on the device that the kernel reads. It prints each
case's max error against ``torch.roll``; on the card all 12 must be 0.

    python -m videoquery_torch.tools.roll_repro
"""

from __future__ import annotations

import numpy as np
import torch

from videoquery_torch.core.device import resolve_device
from videoquery_torch.kernels import roll as t2

H, W = 80, 256
SHIFTS = (1, 5, 8)


def run(device=None, log=print) -> list[float]:
    """The 12 max errors of T2 against torch.roll, axis-major, negative
    shifts first (as the TPU repro orders them)."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.random.default_rng(0).random((1, H, W)).astype(np.float32)).to(dev)
    errs = []
    for axis in (0, 1):
        for negate in (True, False):
            row = []
            for s in SHIFTS:
                shift = torch.tensor([-s if negate else s], dtype=torch.int32, device=dev)
                got = t2.roll(x, shift, axis)
                want = torch.roll(x, -s if negate else s, dims=axis + 1)
                row.append(float((got - want).abs().max()))
            log(f"axis={axis} {'neg' if negate else 'pos'}-shift: max errs {row}")
            errs.extend(row)
    return errs


def main() -> None:
    errs = run()
    bad = sum(e != 0.0 for e in errs)
    print(f"{len(errs) - bad} of {len(errs)} cases exact")
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
