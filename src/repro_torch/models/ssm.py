"""The Mamba2 block's spec (port of ``repro.models.ssm.SSMSpec``).

Only the dataclass lives here for now: ``configs.base`` needs it to count
the parameters of the ``ssm`` and ``hybrid`` families.  The block itself
(chunked scan, recurrent decode) and ``SSMModel`` are still to be ported
(ROADMAP, queue A, A13b).
"""
from __future__ import annotations

from typing import NamedTuple


class SSMSpec(NamedTuple):
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128

    @property
    def d_inner(self):
        return self.expand * self.d_model

    @property
    def n_heads(self):
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self):
        return self.d_inner + 2 * self.d_state  # x, B, C share the conv
