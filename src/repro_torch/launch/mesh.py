"""Production meshes, fake process groups and the card's constants (port of
``repro.launch.mesh``).

The reference lays the production mesh over 256 or 512 fake XLA devices.
The port lays it over a ``DeviceMesh`` of a process group: a real one on
a cluster, or a fake one (``fake_world``) of the same size inside one
process, where the dry run traces one rank's program without its peers.
Functions, never module-level constants, so importing this module starts
no process group.

The roofline's peaks are NVIDIA's data sheet for one H100 SXM (dense
rates, at the card's full 700 W power limit): ``chip_smoke.py`` and the
dry run read them from here.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch.distributed as dist

# NVIDIA H100 SXM (data sheet, dense, 700 W): bf16 tensor-core peak
BF16_FLOPS_PER_S = 989e12
# NVIDIA H100 SXM: HBM3 bandwidth of one card
HBM_BYTES_PER_S = 3.35e12
# NVIDIA H100 SXM: NVLink 4 joins the 8 cards of one node at 900 GB/s a
# card, both directions together (18 links): 450 GB/s each way.  Between
# nodes a card has one 400 Gb/s network port: 50 GB/s each way.  The dry
# run's collective term uses NVLink; a 16-wide axis spans two nodes, so
# that term is a lower bound there.
NVLINK_BYTES_PER_S = 450e9


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names only (JAX's ``AbstractMesh``): enough for the
    spec tables of ``distributed.sharding``, not to place a tensor."""
    shape: tuple
    mesh_dim_names: tuple


def production_shape(multi_pod: bool = False):
    """``((16, 16), ("data", "model"))`` or the 2-pod ``(2, 16, 16)``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks) CPU
    ``DeviceMesh`` over the default process group, which must have that
    many ranks (``fake_world`` for a dry run)."""
    shape, axes = production_shape(multi_pod)
    return make_host_mesh(shape, axes)


def make_host_mesh(shape=None, axes=("data", "model"), *, device_type="cpu"):
    """A ``DeviceMesh`` of ``shape`` over the default process group;
    ``shape=None`` is ``(1, world size)``."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs torch.distributed "
                           "initialised (init_process_group, or fake_world)")
    if shape is None:
        shape = (1, dist.get_world_size())
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """A fake process group of ``n`` ranks in this process, as the default
    group, destroyed on exit.  Its collectives move nothing: the program
    of rank ``rank`` runs as if its ``n - 1`` peers were there."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs PyTorch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            f"PyTorch build lacks: {e}") from e
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
