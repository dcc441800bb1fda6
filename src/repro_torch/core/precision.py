"""Precision-pair policy: the paper's "two data types" as a config object.

The FPGA implementation templates its whole datapath on a (low, high)
precision pair (paper §2, Ref. [10]).  The solvers carry the same idea:
bulk iterations in ``low`` storage, reliable updates in ``high``.  The
kernels store ``low`` fields and links and compute in float32.
"""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
}


def parse_dtype(name):
    """A dtype name ("bfloat16", ...) as a torch dtype; a dtype passes."""
    if not isinstance(name, str):
        return name
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """(low, high) pair for the solvers."""

    low: str = "bfloat16"
    high: str = "float32"

    @property
    def low_dtype(self):
        return parse_dtype(self.low)

    @property
    def high_dtype(self):
        return parse_dtype(self.high)


DEFAULT = PrecisionPolicy(low="bfloat16", high="float32")
CPU_TEST = PrecisionPolicy(low="float32", high="float32")
