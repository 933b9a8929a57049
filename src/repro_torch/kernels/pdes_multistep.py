"""K-step PDES kernel with the event stream generated in-kernel (Hopper).

Port of ``repro.kernels.pdes_multistep.pdes_multistep_counter``, the
engine's fast path (backend ``"pallas_multistep"``).  On a CUDA tensor the
wrapper launches the hand-written kernel in
``csrc/pdes_multistep_counter.cu`` (one block per ring, the ring
double-buffered in shared memory for all K steps; see the note there for
its bound) or raises; on a CPU tensor it runs the plain PyTorch version,
``ref.pdes_multistep_counter_ref``.  There is no other path.

``launches`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import horizon
from ..core.horizon import MOMENT_KEYS
from . import _build
from .ref import ctr_values, pdes_multistep_counter_ref
from .tiling import check_ring_fits

#: Kernel launches made by :func:`pdes_multistep_counter` in this process.
launches = 0

_LIB = "pdes_multistep_counter"


def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    f = lib.pdes_multistep_counter_launch
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                      + [ctypes.c_uint32] * 5 + [ctypes.c_float]
                      + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        f.restype = ctypes.c_int
        g = lib.decode_eta_launch
        g.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_void_p]
        g.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """Integers wrapped mod 2**32, flattened, as the kernel's uint32 bits."""
    t = x.to(torch.int64).reshape(-1) & 0xFFFFFFFF
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def pdes_multistep_counter(tau, ctr, delta_col=None, trial_col=None, *,
                           k_steps: int, n_v: int, delta: float,
                           rd_mode: bool = False, border_both: bool = False):
    """K fused exact-GVT steps with the event stream generated in-kernel.

    Args:
      tau: (B, L) float32 full rings (periodic).
      ctr: (1, 4) integer tensor ``[seed, step0, b0, l0]`` of uint32 values:
        step ``k`` consumes stream step ``step0 + k``; row ``r`` trial
        ``b0 + r`` and PE ``i`` index ``l0 + i``.
      delta_col: optional (B, 1) per-row window widths (``inf`` rows are
        unconstrained); when given, the static ``delta`` is ignored.
      trial_col: optional (B, 1) integer per-row trial indices (wrapped mod
        ``2**32``), used instead of ``b0 + r``.
      k_steps: number of fused steps.

    Returns:
      (tau (B, L), dict of six (K, B) moment planes in ``MOMENT_KEYS``
      order), each step's moments measured after its update.
    """
    global launches
    if tau.ndim != 2 or tau.dtype != torch.float32:
        raise ValueError(f"tau must be (B, L) float32, got "
                         f"{tuple(tau.shape)} {tau.dtype}")
    B, L = tau.shape
    if k_steps < 1:
        raise ValueError(f"k_steps must be >= 1, got {k_steps}")
    if n_v < 1:
        raise ValueError(f"n_v must be >= 1, got {n_v}")
    for name, col in (("delta_col", delta_col), ("trial_col", trial_col)):
        if col is not None and tuple(col.shape) != (B, 1):
            raise ValueError(f"{name} must have shape ({B}, 1), got "
                             f"{tuple(col.shape)}")
    if tau.device.type == "cpu":
        return pdes_multistep_counter_ref(
            tau, ctr, delta_col, trial_col, k_steps=k_steps, n_v=n_v,
            delta=delta, rd_mode=rd_mode, border_both=border_both)
    if tau.device.type != "cuda":
        raise ValueError(f"unsupported device {tau.device}")
    if horizon.eta_override_active():
        raise RuntimeError("the CUDA kernel decodes eta itself and cannot "
                           "honour horizon.eta_override")
    check_ring_fits(L)
    seed, step0, b0, l0 = ctr_values(ctr)
    dev = tau.device
    tau_in = tau.contiguous()
    dcol = None if delta_col is None else \
        delta_col.to(device=dev, dtype=torch.float32).contiguous()
    tcol = None if trial_col is None else \
        _u32_bits(trial_col.to(dev)).contiguous()
    tau_out = torch.empty_like(tau_in)
    stats = torch.empty((len(MOMENT_KEYS), k_steps, B), dtype=torch.float32,
                        device=dev)
    with torch.cuda.device(dev):
        err = _lib().pdes_multistep_counter_launch(
            tau_in.data_ptr(), tau_out.data_ptr(), stats.data_ptr(),
            None if dcol is None else dcol.data_ptr(),
            None if tcol is None else tcol.data_ptr(),
            B, L, k_steps, seed, step0, b0, l0, n_v,
            float(delta),
            int(rd_mode), int(border_both), _stream(dev))
    _check(err, "pdes_multistep_counter launch")
    launches += 1
    return tau_out, dict(zip(MOMENT_KEYS, stats.unbind(0)))


def decode_eta_cuda(w1: torch.Tensor) -> torch.Tensor:
    """η of every word in ``w1`` by the kernel's own device decode.

    ``w1`` is a 1-d CUDA tensor of uint32 values (int32 or int64 carrying
    them); a check of the decode over all ``2**24`` inputs, not a path of
    the engine.
    """
    if w1.device.type != "cuda" or w1.ndim != 1:
        raise ValueError("decode_eta_cuda takes a 1-d CUDA tensor")
    words = _u32_bits(w1).contiguous()
    out = torch.empty(words.shape, dtype=torch.float32, device=w1.device)
    with torch.cuda.device(w1.device):
        err = _lib().decode_eta_launch(words.data_ptr(), out.data_ptr(),
                                       words.numel(), _stream(w1.device))
    _check(err, "decode_eta launch")
    return out
