"""K-step PDES kernels on full rings (Hopper).

Ports of ``repro.kernels.pdes_multistep``:

* :func:`pdes_multistep_counter` (B1), the engine's fast path (backend
  ``"pallas_multistep"``), with the counter stream hashed in the kernel
  (``csrc/pdes_multistep_counter.cu``), in the exact window or the stale
  one (``stale=``: the window's base the ring's minimum of the input tau
  for all K steps);
* :func:`pdes_multistep` (B3), the path of ``ops.simulate``, with the
  event words read from device memory one step at a time
  (``csrc/pdes_multistep.cu``).

Both kernels hold a ring once in shared memory for all K steps, updated
in place, as ``tiling.ring_plan(L)`` lays it out (``csrc/pdes_ring.cuh``;
see the notes in the sources for their bounds): up to
``tiling.MAX_RING_L`` = 57,344 PEs one block a ring with one block barrier
a step; longer rings, up to ``tiling.MAX_GRID_RING_L`` = 7,518,720 (the
paper's 2^20 takes 22 blocks, 6 rings on the 132 SMs), one segment a
block over blocks of one cooperative launch that meet through a small
workspace in global memory once a step, as many whole rings at once as
the card holds (:func:`resident_rings`), the batch in waves.  Above that
B3 raises; B1 runs up to ``tiling.MAX_STREAM_RING_L`` on the same 132
blocks, each keeping ``tiling.MAX_RING_SEG`` PEs of its segment in shared
memory and the rest in device memory (the stream tier), and raises past
it.  On a CUDA tensor a wrapper launches its kernel or raises (a launch
the card refuses raises too); on a CPU tensor it runs the plain PyTorch
version in ``ref``, which takes any L.  There is no other path.

``launches`` (B1) and ``bits_launches`` (B3) count kernel launches, so a
run can show that its main path went through the kernel, and
``rebased_launches`` the B1 launches that wrote tau rebased (``rebase=``);
``offchip_bytes`` counts the bytes of tau that B1's stream-tier launches
read and write in device memory (:func:`offchip_bytes_of`);
``block_chunks`` and ``sm_chunks`` count how much of the card B1's
launches on a split ring (grid or stream tier) hold
(:func:`count_card_share`), and ``prepared_launches`` the B1 launches
made through a prepared pass (:func:`counter_pass`, the engine's chunk
loop), which counts each of its launches in the others as the wrapper
does.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ..core import horizon
from ..core.horizon import MOMENT_KEYS
from . import _build
from .ref import ctr_values, pdes_multistep_counter_ref, pdes_multistep_ref
from .tiling import check_ring_fits, ring_plan

#: Kernel launches made by :func:`pdes_multistep_counter` in this process.
launches = 0
#: Kernel launches made by :func:`pdes_multistep` in this process.
bits_launches = 0
#: Launches of :func:`pdes_multistep_counter` in this process that wrote
#: tau less each ring's last minimum (``rebase=True``).
rebased_launches = 0
#: Bytes of tau that :func:`pdes_multistep_counter`'s launches in this
#: process read and wrote in device memory on the stream tier.
offchip_bytes = 0
#: Block-steps of B1's launches on a split ring in this process: K steps
#: times B rings times the plan's blocks a ring.
block_chunks = 0
#: SM-steps the card gave those launches: K steps times the waves of the
#: rings it holds at once (:func:`rings_at_once`) times its SMs.
sm_chunks = 0
#: B1 launches in this process made through a prepared pass
#: (:func:`counter_pass`); each is counted in ``launches`` too.
prepared_launches = 0

_LIB = "pdes_multistep_counter"
_BITS_LIB = "pdes_multistep"


#: A ring launcher's last arguments: the workspace, its bytes, the stream.
_WORK_STREAM = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    f = lib.pdes_multistep_counter_launch
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                      + [ctypes.c_uint32] * 5 + [ctypes.c_float]
                      + [ctypes.c_int] * 4 + _WORK_STREAM)
        f.restype = ctypes.c_int
        m = lib.pdes_multistep_counter_max_rings
        m.argtypes = [ctypes.c_int] * 4
        m.restype = ctypes.c_int
        g = lib.decode_eta_launch
        g.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_void_p]
        g.restype = ctypes.c_int
        h = lib.site_pick_launch
        h.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_uint32, ctypes.c_void_p]
        h.restype = ctypes.c_int
    return lib


def _bits_lib() -> ctypes.CDLL:
    lib = _build.load(_BITS_LIB)
    f = lib.pdes_multistep_launch
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                      + [ctypes.c_uint32, ctypes.c_float]
                      + [ctypes.c_int] * 2 + _WORK_STREAM)
        f.restype = ctypes.c_int
        m = lib.pdes_multistep_max_rings
        m.argtypes = [ctypes.c_int] * 4
        m.restype = ctypes.c_int
    return lib


def launch_plan(B: int, L: int, *, bits: bool = False) -> dict:
    """The launch of B1 (``bits``: B3) on ``B`` rings of ``L`` PEs (any
    number of steps: they loop inside the block), from
    ``tiling.ring_plan(L)`` (B3's without the stream tier): its ``tier``,
    ``ring_grid`` blocks a ring of a cooperative grid (1 up to
    ``tiling.MAX_RING_L``), so ``ring_grid * B`` blocks of ``threads``
    (over the grid, the kernel's blocks walk them in waves of
    the rings the card holds at once), each owning ``seg`` PEs, of which
    it holds ``dynamic_smem / 4`` in dynamic shared memory beside its
    static partials and log table, and ``offchip_seg`` (the stream tier)
    in device memory.  The wrappers launch with it and the linter's
    ``vmem-budget`` rule reads it, so the two cannot disagree."""
    p = ring_plan(L, stream=not bits)
    return {"grid": (p.blocks * B,), "ring_grid": p.grid,
            "threads": p.threads, "seg": p.seg,
            "dynamic_smem": p.dynamic_smem, "static_smem": p.static_smem,
            "tier": p.tier, "offchip_seg": p.offchip_seg}


def offchip_bytes_of(B: int, L: int, K: int) -> int:
    """Bytes of tau that one B1 launch of ``K`` steps on ``B`` rings of
    ``L`` PEs reads and writes in device memory on the stream tier: each
    block's device rows read and written once a step (0 on the other
    tiers; the first copy in and the neighbours' reads, which L1 serves,
    left out)."""
    return 8 * B * K * ring_plan(L).offchip_pes(L)


def resident_rings(L: int, *, bits: bool = False) -> int:
    """Rings of ``L`` PEs that B1's (``bits``: B3's) launch holds at once
    on the current card: its resident blocks over the plan's ``grid``, for
    the instantiation the plan launches (over a grid, a batch of more runs
    in waves inside the launch; 0 where the card cannot hold one ring,
    whose launch then raises)."""
    p = ring_plan(L, stream=not bits)
    f = (_bits_lib().pdes_multistep_max_rings if bits else
         _lib().pdes_multistep_counter_max_rings)
    n = f(p.grid, p.warps, p.seg, p.keep)
    _build.check(max(0, -n), "pdes_multistep occupancy")
    return n


@functools.lru_cache(maxsize=256)
def rings_at_once(L: int, *, bits: bool = False) -> int:
    """:func:`resident_rings`, asked of the card once a length."""
    return resident_rings(L, bits=bits)


@functools.lru_cache(maxsize=16)
def card_sms(dev: torch.device) -> int:
    """Streaming multiprocessors of CUDA device ``dev``."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def count_card_share(B: int, L: int, K: int, dev: torch.device) -> None:
    """Count a B1 launch of ``K`` steps on ``B`` rings of ``L`` PEs on CUDA
    device ``dev`` (the current device) into :data:`block_chunks` and
    :data:`sm_chunks` where its plan splits a ring over blocks (one such
    block an SM): the blocks it runs, and the card's SMs times the waves
    of :func:`rings_at_once` its batch takes.  Their ratio is the share of
    the card's SMs the launch holds, each wave taken at one wave's time.
    Asks the card nothing once a length is known, so it never waits for
    the device."""
    global block_chunks, sm_chunks
    blocks, sms = _card_share(B, L, K, dev)
    block_chunks += blocks
    sm_chunks += sms


def _card_share(B: int, L: int, K: int, dev) -> tuple[int, int]:
    """What :func:`count_card_share` adds for that launch: ``(blocks,
    SM-steps)``, both 0 on one block a ring."""
    blocks = ring_plan(L).blocks
    if blocks == 1:
        return 0, 0
    return K * B * blocks, K * -(-B // rings_at_once(L)) * card_sms(dev)


#: Bytes of the grid workspace of one ring slot: a counter on its own
#: 128-byte line and two parities of a 32-byte part a block
#: (``csrc/pdes_ring.cuh::ring_grid_bytes``).
GRID_SLOT_BYTES = 128
GRID_PART_BYTES = 32


def _workspace(dev: torch.device, B: int, grid: int) -> torch.Tensor:
    """Room for the ring slots of a cooperative launch of ``B`` rings of
    ``grid`` blocks (at most ``B`` run at once), from torch's caching
    allocator on ``dev`` and the current stream (so no ``cudaMalloc`` once
    a size has been seen); the launcher zeroes the counters before each
    launch."""
    return torch.empty(B * (GRID_SLOT_BYTES + 2 * grid * GRID_PART_BYTES),
                       dtype=torch.uint8, device=dev)


def _work_args(work) -> tuple:
    """A launcher's workspace arguments: its pointer and bytes (none on
    one block)."""
    return (None, 0) if work is None else (work.data_ptr(), work.numel())


def _check_tau(tau) -> None:
    if tau.ndim != 2 or tau.dtype != torch.float32:
        raise ValueError(f"tau must be (B, L) float32, got "
                         f"{tuple(tau.shape)} {tau.dtype}")


def _refuse_eta_override() -> None:
    if horizon.eta_override_active():
        raise RuntimeError("the CUDA kernel decodes eta itself and cannot "
                           "honour horizon.eta_override")


def bits_launch(tau_in, words, tau_out, stats, *, n_v: int, delta: float,
                rd_mode: bool, border_both: bool) -> None:
    """Launch B3 on buffers :func:`pdes_multistep` has checked and made.

    ``words`` is the (K, B, L, 2) int32 tensor of uint32 bit patterns,
    ``tau_out`` (B, L) and ``stats`` (6, K, B) float32 outputs, all
    contiguous on one CUDA device.  Launches with ``tiling.ring_plan(L)``
    (:func:`launch_plan`) and raises on a launch the card refuses; nothing
    falls back.  Counts nothing: timing scripts call it to see the kernel
    alone.
    """
    K, (B, L) = words.shape[0], tau_in.shape
    p = ring_plan(L, stream=False)
    dev = tau_in.device
    with torch.cuda.device(dev):
        work = _workspace(dev, B, p.grid) if p.grid > 1 else None
        err = _bits_lib().pdes_multistep_launch(
            tau_in.data_ptr(), words.data_ptr(), tau_out.data_ptr(),
            stats.data_ptr(), B, L, K, p.warps, p.grid, p.seg, p.keep, n_v,
            float(delta), int(rd_mode), int(border_both),
            *_work_args(work), _build.stream(dev))
    _build.check(err, "pdes_multistep launch")


def counter_launch(tau_in, tau_out, stats, dcol, tcol, ctr, *, n_v: int,
                   delta: float, rd_mode: bool, border_both: bool,
                   rebase: bool = False, stale: bool = False) -> None:
    """Launch B1 on buffers :func:`pdes_multistep_counter` has checked and
    made: ``dcol`` (B, 1) float32 or None, ``tcol`` (B, 1) int32 uint32
    bits or None, ``ctr`` the four uint32 ``(seed, step0, b0, l0)``, and
    ``stats`` (6, K, B).  Launches with ``tiling.ring_plan(L)`` and raises
    on a launch the card refuses.  Counts nothing: timing scripts call it
    to see the kernel alone.  On the stream tier ``tau_out`` holds the
    device rows while the kernel runs.  ``rebase`` writes ``tau_out`` less
    each ring's minimum after the last step; ``stale`` launches the tier's
    stale-window kernel.
    """
    K, (B, L) = stats.shape[1], tau_in.shape
    p = ring_plan(L)
    dev = tau_in.device
    with torch.cuda.device(dev):
        work = _workspace(dev, B, p.grid) if p.grid > 1 else None
        err = _lib().pdes_multistep_counter_launch(
            tau_in.data_ptr(), tau_out.data_ptr(), stats.data_ptr(),
            None if dcol is None else dcol.data_ptr(),
            None if tcol is None else tcol.data_ptr(), B, L, K, p.warps,
            p.grid, p.seg, p.keep, *ctr, n_v, float(delta), int(rd_mode),
            int(border_both), int(rebase), int(stale), *_work_args(work),
            _build.stream(dev))
    _build.check(err, "pdes_multistep_counter launch")


#: Where the ``min`` plane lies among a launch's six moment planes.
_MIN = MOMENT_KEYS.index("min")
_U32 = 0xFFFFFFFF


@contextlib.contextmanager
def counter_pass(tau, seed: int, step0: int, n_steps: int, k_steps: int,
                 delta_col=None, trial_col=None, *, b0: int = 0, n_v: int,
                 delta: float, rd_mode: bool = False,
                 border_both: bool = False, stale: bool = False,
                 keep: bool = True):
    """B1 over the chunks of one pass, prepared once: a context yielding a
    :class:`CounterPass` whose :meth:`~CounterPass.advance` runs the next
    chunk of ``k_steps`` steps (the last of the ``n_steps`` the remainder)
    with one launch, which writes τ less each ring's last minimum (the
    wrapper's ``rebase``: the engine's rebase, taken in B1's last store).

    What :func:`pdes_multistep_counter` does on every call is done here
    once: the checks, the plan, the Δ and trial columns, two τ buffers
    that the chunks alternate between (``tau`` itself is only read), one
    buffer for every chunk's ``(6, k, B)`` moments (one chunk's, reused,
    where ``keep`` is false), the grid's workspace and the stream; on the
    card the context holds ``tau``'s device current.  Chunk ``c`` consumes
    stream steps from ``step0`` plus the steps before it; row ``r`` trial
    ``b0 + r``, or ``trial_col``'s.  ``seed``, ``step0`` and ``b0`` are
    taken mod ``2**32``; the rest as :func:`pdes_multistep_counter`.  Each
    launch is counted as the wrapper counts it, and in
    :data:`prepared_launches`.  On CPU tensors each chunk calls
    :func:`pdes_multistep_counter` (its plain version) into the same
    buffers.
    """
    kw = dict(n_v=n_v, delta=delta, rd_mode=rd_mode,
              border_both=border_both, rebase=True, stale=stale)
    on_card = tau.device.type == "cuda"
    with torch.cuda.device(tau.device) if on_card else \
            contextlib.nullcontext():
        yield CounterPass(tau, seed, step0, n_steps, k_steps, delta_col,
                          trial_col, b0, keep, kw)


class CounterPass:
    """A pass of B1 chunks that :func:`counter_pass` has prepared."""

    def __init__(self, tau, seed, step0, n_steps, k_steps, delta_col,
                 trial_col, b0, keep, kw):
        _check_tau(tau)
        B, L = tau.shape
        if not 1 <= k_steps <= n_steps:
            raise ValueError(f"need 1 <= k_steps <= n_steps, got k_steps="
                             f"{k_steps}, n_steps={n_steps}")
        if kw["n_v"] < 1:
            raise ValueError(f"n_v must be >= 1, got {kw['n_v']}")
        for name, col in (("delta_col", delta_col), ("trial_col", trial_col)):
            if col is not None and tuple(col.shape) != (B, 1):
                raise ValueError(f"{name} must have shape ({B}, 1), got "
                                 f"{tuple(col.shape)}")
        dev = tau.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev}")
        full, rem = divmod(n_steps, k_steps)
        #: The steps of each chunk, in order.
        self.sizes = (k_steps,) * full + ((rem,) if rem else ())
        self._B, self._L, self._n, self._keep = B, L, n_steps, keep
        self._c, self._step = 0, step0
        self._seed, self._b0, self._kw = seed & _U32, b0 & _U32, kw
        self._tau = tau.contiguous()
        self._out = [torch.empty_like(self._tau) for _ in self.sizes[:2]]
        # chunk c's (6, k, B) moments start at element _at[c] of _stats
        self._at = [6 * B * k_steps * c if keep else 0
                    for c in range(len(self.sizes))]
        self._stats = torch.empty(6 * B * (n_steps if keep else k_steps),
                                  dtype=torch.float32, device=dev)
        self._cols = (delta_col, trial_col)
        self._on_card = dev.type == "cuda"
        if not self._on_card:
            return
        _refuse_eta_override()
        check_ring_fits(L)
        p = ring_plan(L)
        self._kernel_cols = (
            None if delta_col is None else
            delta_col.to(device=dev, dtype=torch.float32).contiguous(),
            None if trial_col is None else
            _build.u32_bits(trial_col.to(dev)).contiguous())
        self._col_ptrs = tuple(None if c is None else c.data_ptr()
                               for c in self._kernel_cols)
        self._work = _workspace(dev, B, p.grid) if p.grid > 1 else None
        self._fn = _lib().pdes_multistep_counter_launch
        self._plan = (p.warps, p.grid, p.seg, p.keep)
        self._tail = (kw["n_v"], float(kw["delta"]), int(kw["rd_mode"]),
                      int(kw["border_both"]), int(kw["rebase"]),
                      int(kw["stale"]), *_work_args(self._work),
                      _build.stream(dev))
        # what each launch adds to the counters, by its steps
        self._counts = {k: (offchip_bytes_of(B, L, k),
                            *_card_share(B, L, k, dev))
                        for k in set(self.sizes)}

    def advance(self):
        """Run the next chunk: its τ (B, L), one of the pass's buffers, and
        its last ``min`` moment (B,), a view of the moments' buffer: the
        shift B1 took from τ."""
        c = self._c
        k, at, B = self.sizes[c], self._at[c], self._B
        tau_in = self._tau if c == 0 else self._out[(c - 1) % 2]
        tau_out = self._out[c % 2]
        if self._on_card:
            self._kernel(tau_in, tau_out, at, k)
        else:
            self._plain(tau_in, tau_out, at, k)
        self._c, self._step = c + 1, self._step + k
        last = at + (_MIN * k + k - 1) * B
        return tau_out, self._stats[last:last + B]

    def moments(self) -> dict:
        """Every step's moments, each a (n_steps, B) plane in step order, in
        ``MOMENT_KEYS`` order: one reordering copy of the chunks' moments,
        after the last chunk of a pass that keeps them."""
        self._check_kept()
        B, K, n = self._B, self.sizes[0], self._n
        full = n - n % K
        out = torch.empty((len(MOMENT_KEYS), n, B), dtype=torch.float32,
                          device=self._stats.device)
        out[:, :full].view(-1, full // K, K, B).copy_(
            self._stats[:6 * B * full].view(full // K, -1, K, B)
            .transpose(0, 1))
        if full < n:
            out[:, full:].copy_(self._slot(6 * B * full, n - full))
        return dict(zip(MOMENT_KEYS, out.unbind(0)))

    def chunk_moments(self, c: int) -> dict:
        """Chunk ``c``'s moments as the wrapper returns them: six (k, B)
        planes of its ``(6, k, B)`` slot."""
        self._check_kept()
        return dict(zip(MOMENT_KEYS,
                        self._slot(self._at[c], self.sizes[c]).unbind(0)))

    def _check_kept(self) -> None:
        if not self._keep or self._c < len(self.sizes):
            raise RuntimeError("the moments are read after the last chunk "
                               "of a pass that keeps them")

    def _slot(self, at: int, k: int) -> torch.Tensor:
        return self._stats[at:at + 6 * k * self._B].view(6, k, self._B)

    def _plain(self, tau_in, tau_out, at, k) -> None:
        ctr = torch.tensor([[self._seed, self._step & _U32, self._b0, 0]],
                           dtype=torch.int64)
        t, m = pdes_multistep_counter(tau_in, ctr, *self._cols, k_steps=k,
                                      **self._kw)
        tau_out.copy_(t)
        self._slot(at, k).copy_(torch.stack([m[key] for key in MOMENT_KEYS]))

    def _kernel(self, tau_in, tau_out, at, k) -> None:
        global launches, rebased_launches, offchip_bytes, block_chunks, \
            sm_chunks, prepared_launches
        err = self._fn(
            tau_in.data_ptr(), tau_out.data_ptr(),
            self._stats.data_ptr() + 4 * at, *self._col_ptrs, self._B,
            self._L, k, *self._plan, self._seed, self._step & _U32, self._b0,
            0, *self._tail)
        _build.check(err, "pdes_multistep_counter launch")
        offchip, blocks, sms = self._counts[k]
        launches += 1
        rebased_launches += 1
        offchip_bytes += offchip
        block_chunks += blocks
        sm_chunks += sms
        prepared_launches += 1


def pdes_multistep(tau, bits, *, n_v: int, delta: float,
                   rd_mode: bool = False, border_both: bool = False):
    """K fused exact-GVT steps on full rings, the words read from memory.

    Args:
      tau: (B, L) float32 full rings (periodic).
      bits: (K, B, L, 2) event words of the K steps as int32 uint32 bit
        patterns, as ``threefry.threefry_bits`` makes them; the plain
        version on CPU tensors also takes int64-carried uint32 values.
      n_v: sites per PE.
      delta: static window width; ``inf`` turns the window rule off.

    Returns:
      (tau (B, L), dict of six (K, B) moment planes in ``MOMENT_KEYS``
      order), each step's moments measured after its update.
    """
    global bits_launches
    _check_tau(tau)
    B, L = tau.shape
    if bits.ndim != 4 or tuple(bits.shape[1:]) != (B, L, 2) or \
            bits.shape[0] < 1 or bits.dtype not in (torch.int32,
                                                    torch.int64):
        raise ValueError(f"bits must be (K, {B}, {L}, 2) int32 or int64 "
                         f"with K >= 1, got {tuple(bits.shape)} {bits.dtype}")
    if n_v < 1:
        raise ValueError(f"n_v must be >= 1, got {n_v}")
    if bits.device != tau.device:
        raise ValueError(f"tau and bits must share a device, got "
                         f"{tau.device} and {bits.device}")
    kw = dict(n_v=n_v, delta=delta, rd_mode=rd_mode, border_both=border_both)
    if tau.device.type == "cpu":
        return pdes_multistep_ref(tau, bits, **kw)
    if tau.device.type != "cuda":
        raise ValueError(f"unsupported device {tau.device}")
    _refuse_eta_override()
    check_ring_fits(L, stream=False)
    K = bits.shape[0]
    dev = tau.device
    if bits.dtype != torch.int32:
        raise ValueError(f"on the GPU, bits must be int32 bit patterns, got "
                         f"{bits.dtype}")
    words = bits.contiguous()
    tau_in = tau.contiguous()
    tau_out = torch.empty_like(tau_in)
    stats = torch.empty((len(MOMENT_KEYS), K, B), dtype=torch.float32,
                        device=dev)
    bits_launch(tau_in, words, tau_out, stats, **kw)
    bits_launches += 1
    return tau_out, dict(zip(MOMENT_KEYS, stats.unbind(0)))


def pdes_multistep_counter(tau, ctr, delta_col=None, trial_col=None, *,
                           k_steps: int, n_v: int, delta: float,
                           rd_mode: bool = False, border_both: bool = False,
                           rebase: bool = False, stale: bool = False):
    """K fused steps with the event stream generated in-kernel.

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
      rebase: return tau less each ring's minimum after the last step,
        which is ``moments["min"][-1]`` bit for bit (the engine's rebase,
        taken in the kernel's last store); the moments are unchanged.
      stale: the stale window: every step's bound is its Δ plus the ring's
        minimum of the input ``tau`` (the chunk's first GVT), not the
        step's own GVT; the moments are still each step's.

    Returns:
      (tau (B, L), dict of six (K, B) moment planes in ``MOMENT_KEYS``
      order), each step's moments measured after its update.
    """
    global launches, offchip_bytes, rebased_launches
    _check_tau(tau)
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
            delta=delta, rd_mode=rd_mode, border_both=border_both,
            rebase=rebase, stale=stale)
    if tau.device.type != "cuda":
        raise ValueError(f"unsupported device {tau.device}")
    _refuse_eta_override()
    check_ring_fits(L)
    seed, step0, b0, l0 = ctr_values(ctr)
    dev = tau.device
    tau_in = tau.contiguous()
    dcol = None if delta_col is None else \
        delta_col.to(device=dev, dtype=torch.float32).contiguous()
    tcol = None if trial_col is None else \
        _build.u32_bits(trial_col.to(dev)).contiguous()
    tau_out = torch.empty_like(tau_in)
    stats = torch.empty((len(MOMENT_KEYS), k_steps, B), dtype=torch.float32,
                        device=dev)
    counter_launch(tau_in, tau_out, stats, dcol, tcol, (seed, step0, b0, l0),
                   n_v=n_v, delta=delta, rd_mode=rd_mode,
                   border_both=border_both, rebase=rebase, stale=stale)
    launches += 1
    rebased_launches += bool(rebase)
    offchip_bytes += offchip_bytes_of(B, L, k_steps)
    with torch.cuda.device(dev):
        count_card_share(B, L, k_steps, dev)
    return tau_out, dict(zip(MOMENT_KEYS, stats.unbind(0)))


def decode_eta_cuda(w1: torch.Tensor, *, table: bool = True) -> torch.Tensor:
    """η of every word in ``w1`` by the kernels' own device decode.

    ``table`` picks the table decode of B1 and B3 (``neg_log_rn``); else the
    library fp64 ``log`` that B2 takes.  ``w1`` is a 1-d CUDA tensor of
    uint32 values (int32 or int64 carrying them); a check of the decode
    over all ``2**24`` inputs, not a path of the engine.
    """
    if w1.device.type != "cuda" or w1.ndim != 1:
        raise ValueError("decode_eta_cuda takes a 1-d CUDA tensor")
    words = _build.u32_bits(w1).contiguous()
    out = torch.empty(words.shape, dtype=torch.float32, device=w1.device)
    with torch.cuda.device(w1.device):
        err = _lib().decode_eta_launch(words.data_ptr(), out.data_ptr(),
                                       words.numel(), int(table),
                                       _build.stream(w1.device))
    _build.check(err, "decode_eta launch")
    return out


def site_pick_cuda(w0: torch.Tensor, n_v: int) -> torch.Tensor:
    """The site ``w0 % n_v`` of every word by the kernels' own division-free
    pick (``csrc/pdes_common.cuh::site_of``), as int64.

    ``w0`` is a 1-d CUDA tensor of uint32 values (int32 or int64 carrying
    them); a check of the pick over many words, not a path of the engine.
    """
    if w0.device.type != "cuda" or w0.ndim != 1:
        raise ValueError("site_pick_cuda takes a 1-d CUDA tensor")
    if not 1 <= n_v < 1 << 32:
        raise ValueError(f"n_v must be in [1, 2**32), got {n_v}")
    words = _build.u32_bits(w0).contiguous()
    out = torch.empty(words.shape, dtype=torch.int32, device=w0.device)
    with torch.cuda.device(w0.device):
        err = _lib().site_pick_launch(words.data_ptr(), out.data_ptr(),
                                      words.numel(), n_v,
                                      _build.stream(w0.device))
    _build.check(err, "site_pick launch")
    return out.to(torch.int64) & 0xFFFFFFFF
