"""``--mesh`` as process ranks: start them, join them, bring them down.

``repro.service`` runs a sharded service in one process over the devices
of a JAX mesh (on a host without them, ``--fake-devices`` makes XLA show
N CPU devices).  The port runs one process per shard instead (see
``core/mesh.py``), so ``python -m repro_torch.service ... --mesh
data=2,model=4`` is a launcher: with no ``RANK`` in its environment it
starts ``prod(sizes)`` copies of its own command line, each with
``RANK``, ``WORLD_SIZE`` and a ``file://`` rendezvous in a fresh temp
dir, and waits for them.  Each copy finds ``RANK`` set and runs as that
rank (:func:`init_rank`): gloo ranks on the CPU with ``--device cpu``,
otherwise NCCL ranks, rank r on ``cuda:r``.

* When any rank exits non-zero, the launcher kills the rest and exits
  with that rank's code.
* SIGTERM and SIGINT sent to the launcher are forwarded to every rank.
* On the GPU a world larger than the visible GPU count exits 2 with a
  message saying so; nothing falls back to gloo or to the CPU.

A rank whose ``RANK`` another launcher set (``torchrun`` also sets
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``) initialises from
``env://``, torch's default, in place of the file rendezvous.
"""
from __future__ import annotations

import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

__all__ = ["RENDEZVOUS_ENV", "in_rank", "world_problem", "self_command",
           "run_ranks", "init_rank"]

#: environment variable carrying the launcher's rendezvous URL to its ranks
RENDEZVOUS_ENV = "REPRO_TORCH_RENDEZVOUS"


def in_rank() -> bool:
    """True in a process started as one rank of a launch."""
    return "RANK" in os.environ


def world_problem(world: int, device: str) -> str | None:
    """Why ``world`` ranks cannot run on ``device``, or None if they can."""
    if device != "cuda":
        return None
    import torch
    n = torch.cuda.device_count()
    if world <= n:
        return None
    return (f"--mesh needs {world} GPU(s), one a rank, and {n} "
            f"{'is' if n == 1 else 'are'} visible; NCCL takes one rank per "
            f"GPU, and the port does not fall back to gloo or the CPU "
            f"(--device cpu runs gloo ranks on the CPU)")


def self_command(argv, module: str) -> list[str]:
    """The command line that starts one more copy of this process.

    From the command line (``argv is None``) that is the interpreter's own
    original command line, options and all; a caller that passed its
    arguments in gets ``python -m module *argv``.
    """
    if argv is None:
        return [sys.executable, *sys.orig_argv[1:]]
    return [sys.executable, "-m", module, *argv]


def run_ranks(cmd: list[str], world: int, *, poll_s: float = 0.05) -> int:
    """Run ``world`` copies of ``cmd`` as the ranks of one group; wait.

    Returns 0 when every rank exits 0, else the first failing rank's code
    (``128 + n`` for a rank killed by signal ``n``), once the rest are
    killed.
    """
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    env = dict(os.environ, WORLD_SIZE=str(world),
               **{RENDEZVOUS_ENV: "file://" + os.path.join(tmp, "store")})
    # a rank's share of the host's cores, unless the caller chose
    env.setdefault("OMP_NUM_THREADS",
                   str(max(1, (os.cpu_count() or 1) // world)))
    procs: list[subprocess.Popen] = []

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    old = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old[sig] = signal.signal(sig, forward)
        except ValueError:          # not the main thread: no forwarding
            pass
    try:
        for r in range(world):
            procs.append(subprocess.Popen(cmd, env=dict(env, RANK=str(r))))
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                rc = failed[0]
                break
            if all(c == 0 for c in codes):
                rc = 0
                break
            time.sleep(poll_s)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for sig, handler in old.items():
            signal.signal(sig, handler)
        shutil.rmtree(tmp, ignore_errors=True)
    return 128 - rc if rc < 0 else rc


def init_rank(axes: list[tuple[str, int]], device: str):
    """Join this rank's process group and build its mesh over ``axes``.

    Collective: every rank of the launch calls it.  ``device`` is
    ``"cpu"`` (gloo) or ``"cuda"`` (NCCL, rank r on ``cuda:r``); raises
    ``RuntimeError`` for ``"cuda"`` without CUDA.
    """
    import torch
    import torch.distributed as dist

    from ..core.mesh import make_mesh
    from ..device import resolve_device

    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    names = [n for n, _ in axes]
    sizes = [s for _, s in axes]
    if math.prod(sizes) != world:
        raise ValueError(f"--mesh {dict(axes)} has {math.prod(sizes)} ranks, "
                         f"WORLD_SIZE is {world}")
    if device == "cpu":
        dev, backend = resolve_device("cpu"), "gloo"
    else:
        dev = resolve_device(f"cuda:{rank}")
        torch.cuda.set_device(dev)
        backend = "nccl"
    dist.init_process_group(
        backend, init_method=os.environ.get(RENDEZVOUS_ENV, "env://"),
        rank=rank, world_size=world)
    return make_mesh(sizes, names, device=dev)
