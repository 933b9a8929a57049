"""The threefry event words of a chunk of steps, generated on the GPU.

Not the port of a TPU kernel: ``repro`` draws these bits with
``jax.random`` in XLA, outside Pallas.  On the GPU the plain version,
``core/prng.py``, would be about 150 elementwise int64 launches over the
whole ``(K, B, L, 2)`` chunk, so a small CUDA kernel
(``csrc/threefry_bits.cu``) writes the words instead, as uint32 bit
patterns in an int32 tensor, the layout B3 (``pdes_multistep``) reads.

On a CUDA key the wrapper launches the kernel or raises; on a CPU key it
runs the plain version, :func:`threefry_bits_plain`.  Both return int32 bit
patterns; a plain consumer widens them to the int64 carrier itself
(``horizon.event_bits``).  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core import prng
from . import _build

#: Kernel launches made by :func:`threefry_bits` in this process.
launches = 0

_LIB = "threefry_bits"

#: Threads of a block and word pairs each thread writes a step
#: (``kThreads``, ``kPairsPerThread`` in ``csrc/threefry_bits.cu``).
THREADS, PAIRS_PER_THREAD = 256, 4


def launch_plan(n_steps: int, n_pairs: int) -> dict:
    """The generator's launch for ``n_steps`` steps of ``n_pairs`` word
    pairs: a grid of (blocks, steps), blocks capped at 65,535 (threads then
    stride), no shared memory; ``csrc/threefry_bits.cu``'s launcher sizes
    the same grid from the same two numbers."""
    per_block = THREADS * PAIRS_PER_THREAD
    return {"grid": (min(-(-n_pairs // per_block), 65535), n_steps),
            "threads": THREADS, "dynamic_smem": 0, "static_smem": 0}


def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    f = lib.threefry_bits_launch
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
        f.restype = ctypes.c_int
    return lib


def _check_out(out, n_steps, shape, dev) -> torch.Tensor:
    want = (n_steps, *shape, 2)
    if out is None:
        return torch.empty(want, dtype=torch.int32, device=dev)
    if tuple(out.shape) != want or out.dtype != torch.int32 or \
            out.device != dev or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {want} int32 tensor on "
                         f"{dev}, got {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}")
    return out


def threefry_bits_plain(key, step0: int, n_steps: int, shape, out=None):
    """The plain version of :func:`threefry_bits`, on ``key``'s device."""
    shape = tuple(int(s) for s in shape)
    out = _check_out(out, n_steps, shape, key.device)
    for i in range(n_steps):
        words = prng.random_bits(prng.fold_in(key, step0 + i), shape + (2,))
        out[i] = _build.u32_bits(words).reshape(words.shape)
    return out


def threefry_bits(key, step0: int, n_steps: int, shape, out=None):
    """Event words of steps ``step0 .. step0 + n_steps - 1``.

    Args:
      key: ``(2,)`` int64 threefry key (``core.prng``); its device decides
        where the words are made.
      step0: the first step index (wrapped mod ``2**32``, as JAX's
        ``fold_in`` does).
      n_steps: number of consecutive steps, K.
      shape: the ensemble shape of one step, e.g. ``(B, L)``.
      out: optional contiguous int32 ``(K, *shape, 2)`` buffer to fill.

    Returns:
      ``(K, *shape, 2)`` int32 tensor of uint32 bit patterns: entry
      ``[k, ..., j]`` is word ``j`` of ``jax.random.bits(fold_in(key,
      step0 + k), shape + (2,))``.
    """
    global launches
    prng.key_data(key)
    shape = tuple(int(s) for s in shape)
    if n_steps < 1 or min(shape, default=1) < 1:
        raise ValueError(f"need n_steps >= 1 and a non-empty shape, got "
                         f"{n_steps} and {shape}")
    dev = key.device
    if dev.type == "cpu":
        return threefry_bits_plain(key, step0, n_steps, shape, out)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = _check_out(out, n_steps, shape, dev)
    key = key.contiguous()
    with torch.cuda.device(dev):
        err = _lib().threefry_bits_launch(
            key.data_ptr(), int(step0) & 0xFFFFFFFF, n_steps,
            math.prod(shape), out.data_ptr(), _build.stream(dev))
    _build.check(err, "threefry_bits launch")
    launches += 1
    return out

