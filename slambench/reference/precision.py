"""The precisions the reference runs in.

* ``float64``: the reference itself;
* ``float32``: the same code in float32 with exact float32 products, a
  witness of what an honest float32 program with another summation order
  reads against the reference;
* ``tf32``: the control, the precision below the configuration's float32
  with TF32 off: float32, with every operand of a matrix product or linear
  solve rounded to TF32's 10-bit mantissa (round to nearest, ties to even),
  as the card's tensor cores take it.  Emulated bit for bit, so it reads
  the same on the CPU and on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def tf32_np(x: np.ndarray) -> np.ndarray:
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & 0xFFFFE000
    out = b.astype(np.uint32).view(np.float32)
    return np.where(np.isfinite(x), out, np.asarray(x, np.float32))


def tf32_torch(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32).contiguous()
    b = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0x0FFF + ((b >> 13) & 1)) & 0xFFFFE000
    b = torch.where(b >= 2**31, b - 2**32, b).to(torch.int32)
    return torch.where(torch.isfinite(x), b.view(torch.float32), x)


@dataclass(frozen=True)
class Precision:
    name: str

    @property
    def np_dtype(self):
        return np.float64 if self.name == "float64" else np.float32

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.name == "float64" else torch.float32

    def operand(self, x):
        """``x`` as an operand of a matrix product or solve."""
        if isinstance(x, torch.Tensor):
            x = x.to(self.dtype)
            return tf32_torch(x) if self.name == "tf32" else x
        x = np.asarray(x, self.np_dtype)
        return tf32_np(x) if self.name == "tf32" else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` (batched alike) with both operands as the precision
        takes them, accumulated in its dtype."""
        return self.operand(a) @ self.operand(b)


FLOAT64, FLOAT32, TF32 = Precision("float64"), Precision("float32"), Precision("tf32")
PRECISIONS = {p.name: p for p in (FLOAT64, FLOAT32, TF32)}
