"""One-step PDES kernel on a haloed chunk (Hopper).

Port of ``repro.kernels.pdes_step.pdes_step``, the engine's ``pallas``
backend and the only fused path for ``window="stale"``.  On a CUDA tensor
the wrapper launches the hand-written kernel in ``csrc/pdes_step.cu`` (one
block per row, threads striding over the row; see the note there for its
bound) or raises; on a CPU tensor it runs the plain PyTorch version,
``ref.pdes_step_ref``.  There is no other path.

The window base ``gvt`` comes from the caller: the exact minimum, the stale
per-chunk one, or either with a per-row Δ folded in (``gvt + delta_col``
with a static ``delta`` of 0, as the engine does).  Rows may be of any
length: the kernel keeps nothing of a row in shared memory.

``launches`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import horizon
from ..core.horizon import MOMENT_KEYS
from . import _build
from .ref import pdes_step_ref

#: Kernel launches made by :func:`pdes_step` in this process.
launches = 0

_LIB = "pdes_step"


def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    f = lib.pdes_step_launch
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                      + [ctypes.c_uint32, ctypes.c_float]
                      + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return lib


def launch(tau_h, words, gvt, tau_out, stats, *, n_v: int, delta: float,
           rd_mode: bool, border_both: bool) -> None:
    """Launch the kernel on buffers :func:`pdes_step` has checked and made.

    ``words`` is the (B, Lc, 2) int32 tensor of uint32 bit patterns,
    ``tau_out`` (B, Lc) and ``stats`` (6, B) float32 outputs, all
    contiguous on one CUDA device.  Counts nothing: timing scripts call it
    to see the kernel alone.
    """
    B, Lc = tau_out.shape
    dev = tau_out.device
    with torch.cuda.device(dev):
        err = _lib().pdes_step_launch(
            tau_h.data_ptr(), words.data_ptr(), gvt.data_ptr(),
            tau_out.data_ptr(), stats.data_ptr(), B, Lc, n_v, float(delta),
            int(rd_mode), int(border_both), _build.stream(dev))
    _build.check(err, "pdes_step launch")


def pdes_step(tau_haloed, bits, gvt, *, n_v: int, delta: float,
              rd_mode: bool = False, border_both: bool = False):
    """One fused PDES step on a haloed chunk.

    Args:
      tau_haloed: (B, Lc + 2) float32 local times with the neighbour halo
        columns at ``[:, 0]`` and ``[:, -1]``.
      bits: (B, Lc, 2) int64 carrying uint32 event words, as
        ``counter_bits_block`` gives them; the kernel reads them as uint32.
      gvt: (B, 1) float32 window base.
      delta: static window width; ``inf`` turns the window rule off.

    Returns:
      (tau_next (B, Lc), dict of six (B,) moments in ``MOMENT_KEYS`` order).
    """
    global launches
    if tau_haloed.ndim != 2 or tau_haloed.dtype != torch.float32 or \
            tau_haloed.shape[0] < 1 or tau_haloed.shape[1] < 3:
        raise ValueError(f"tau_haloed must be (B, Lc + 2) float32 with "
                         f"B, Lc >= 1, got {tuple(tau_haloed.shape)} "
                         f"{tau_haloed.dtype}")
    B, Lc = tau_haloed.shape[0], tau_haloed.shape[1] - 2
    if tuple(bits.shape) != (B, Lc, 2) or bits.dtype != torch.int64:
        raise ValueError(f"bits must be ({B}, {Lc}, 2) int64, got "
                         f"{tuple(bits.shape)} {bits.dtype}")
    if tuple(gvt.shape) != (B, 1) or gvt.dtype != torch.float32:
        raise ValueError(f"gvt must be ({B}, 1) float32, got "
                         f"{tuple(gvt.shape)} {gvt.dtype}")
    if n_v < 1:
        raise ValueError(f"n_v must be >= 1, got {n_v}")
    dev = tau_haloed.device
    if bits.device != dev or gvt.device != dev:
        raise ValueError(f"tau_haloed, bits and gvt must share a device, got "
                         f"{dev}, {bits.device}, {gvt.device}")
    if dev.type == "cpu":
        tau_next, _, moments = pdes_step_ref(
            tau_haloed, bits, gvt, n_v=n_v, delta=delta, rd_mode=rd_mode,
            border_both=border_both)
        return tau_next, moments
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if horizon.eta_override_active():
        raise RuntimeError("the CUDA kernel decodes eta itself and cannot "
                           "honour horizon.eta_override")
    words = _build.u32_bits(bits).reshape(B, Lc, 2)
    tau_out = torch.empty((B, Lc), dtype=torch.float32, device=dev)
    stats = torch.empty((len(MOMENT_KEYS), B), dtype=torch.float32,
                        device=dev)
    launch(tau_haloed.contiguous(), words, gvt.contiguous(), tau_out, stats,
           n_v=n_v, delta=delta, rd_mode=rd_mode, border_both=border_both)
    launches += 1
    return tau_out, dict(zip(MOMENT_KEYS, stats.unbind(0)))
