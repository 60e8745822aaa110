"""Module middleware base.

Counterpart of the reference's BaseModule (graphlily/module/base_module.h).
Where the reference wraps OpenCL state (xclbin program, queues, kernel args,
`cl::Buffer`s with HBM placement), these modules wrap jitted
functions plus `DeviceBuffer` holders.

`DeviceBuffer` reproduces the reference's zero-copy buffer *binding*
(module/spmv_module.h:463-467, app/bfs.h:113-116): a bind makes two modules
share one mutable holder, so one module's `run()` output is the next module's
input without a host copy. jax arrays are immutable, so the holder is the
mutable cell; arrays stay on device. (Apps additionally provide fused
`lax.while_loop` paths where the whole iteration is one device program —
the performant analog of the reference's chained on-device execution.)
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..config import EngineConfig, DEFAULT_CONFIG
from ..semiring import Semiring, MaskType


class DeviceBuffer:
    """Mutable holder for a device array (or SparseVector pytree)."""

    __slots__ = ("value",)

    def __init__(self, value: Any = None):
        self.value = value

    def __repr__(self):
        return f"DeviceBuffer({type(self.value).__name__})"


class BaseModule:
    """Holds semiring/mask state and the engine config.

    Reference: graphlily/module/base_module.h:10-133. `set_up_runtime`
    (xclbin load + device program) has no counterpart — jit compilation
    happens on first run and is cached.
    """

    def __init__(self, config: EngineConfig = DEFAULT_CONFIG):
        self.config = config
        self.semiring_: Optional[Semiring] = None
        self.mask_type_: MaskType = MaskType.NO_MASK

    def set_semiring(self, semiring: Semiring) -> None:
        self.semiring_ = semiring

    def set_mask_type(self, mask_type: MaskType) -> None:
        self.mask_type_ = mask_type

    # API-parity no-ops (the reference programs the FPGA here):
    def set_up_runtime(self, *_args, **_kw) -> None:
        return None

    @staticmethod
    def copy_buffer_device_to_device(src: DeviceBuffer, dst: DeviceBuffer,
                                     _nbytes: int | None = None) -> None:
        """Reference: base_module.h:82-85 (enqueueCopyBuffer). Device arrays
        are immutable so this is a reference copy."""
        dst.value = src.value
