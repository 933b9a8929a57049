"""Sharding rules: logical param/activation roles -> specs and DTensor
placements (port of ``repro.distributed.sharding``).

Strategy, as the reference's: FSDP over the ``data`` axis (parameter
dim-0 sharding, gathered on use, ZeRO-3 style) combined with tensor
parallelism over the ``model`` axis (Megatron column/row sharding of
attention heads and FFN hidden).  Batch shards over (pod, data).  Dims
that do not divide their axis fall back to replication (e.g. arctic's 56
heads on a 16-way TP axis).  MoE expert weights keep experts unsharded
and shard d_ff over TP; the decode profile keeps weights resident (EP
over ``data`` + TP); KV caches shard batch over dp and sequence over TP.

A *spec* is the reference's ``PartitionSpec`` as a plain tuple, one entry
a tensor dim: ``None``, an axis name, or a tuple of names.  The tables
(``param_pspecs``, ``batch_pspecs``, ``cache_pspecs``, ``make_constrain``'s
``spec_for``) are the reference's, rule for rule.  ``to_placements`` maps
a spec onto a ``DeviceMesh`` as one ``Shard(d)`` or ``Replicate()`` per
mesh dim: DTensor carries the layout, and ``constrain`` redistributes an
activation to its role's placements where the reference has
``with_sharding_constraint``.  A mesh dim of size 1 is always
``Replicate()`` (sharding over one rank is no sharding), so a ``(1, 1)``
mesh runs the plain path's local ops.

``Parallelism.mesh`` is a ``DeviceMesh``, or an ``AbstractMesh``
(``launch/mesh.py``: sizes and names only) where only the spec tables are
wanted.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..tree import tree_map, tree_map_with_path


@dataclasses.dataclass(frozen=True)
class Parallelism:
    mesh: object                             # DeviceMesh or AbstractMesh
    dp_axes: tuple[str, ...] = ("data",)     # batch (includes "pod" if present)
    fsdp_axis: Optional[str] = "data"        # param dim-0 sharding
    tp_axis: Optional[str] = "model"
    # expert-parallel joint-batch profile: batch shards over (dp, tp)
    # everywhere, MoE experts shard over tp, dense FFN/vocab give up tp
    # sharding.  Requires global_batch % (dp·tp) == 0.
    joint_batch: bool = False
    # decode profile: weights stay resident (no FSDP gather per decode
    # step): experts shard over the data axis (EP) + d_ff/heads over TP.
    serve: bool = False

    def axis_size(self, name) -> int:
        if name is None:
            return 1
        sizes = mesh_sizes(self.mesh)
        if isinstance(name, tuple):
            s = 1
            for n in name:
                s *= sizes[n]
            return s
        return sizes[name]

    def div(self, axis, dim: int):
        """axis name if dim divides the axis size, else None (replicate)."""
        return axis if axis is not None and dim % self.axis_size(axis) == 0 \
            else None


def mesh_sizes(mesh) -> dict:
    """Axis name -> size of a ``DeviceMesh`` (or ``AbstractMesh``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _spec(*entries) -> tuple:
    """A spec of ``entries``, a one-name tuple entry written as the name
    (as ``PartitionSpec`` normalizes it)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _param_spec(path: str, shape, par: Parallelism) -> tuple:
    """Spec for the *trailing* (base) dims; leading stack dims -> None."""
    fs, tp = par.fsdp_axis, par.tp_axis
    name = path.split("'")[-2] if "'" in path else path

    def base() -> tuple:
        if par.serve:
            return _serve_base(name, path, shape, par)
        if name in ("table", "lm_head"):                 # (V, d) vocab-TP
            if par.joint_batch:                          # vocab replicated
                return (None, par.div(fs, shape[-1]))
            return (par.div(tp, shape[-2]), par.div(fs, shape[-1]))
        if name == "pos_table":
            return (None, par.div(fs, shape[-1]))
        if name == "wq":                                 # (d, H, hd)
            return (par.div(fs, shape[-3]), par.div(tp, shape[-2]), None)
        if name in ("wk", "wv"):                         # (d, KH, hd)
            return (par.div(fs, shape[-3]), par.div(tp, shape[-2]), None)
        if name == "wo" and len(shape) >= 3 and "'moe'" not in path:
            return (par.div(tp, shape[-3]), None, par.div(fs, shape[-1]))
        if "'moe'" in path:
            if par.joint_batch:                          # EP over tp
                if name in ("wi", "wg"):                 # (E, d, f)
                    return (par.div(tp, shape[-3]), par.div(fs, shape[-2]),
                            None)
                if name == "wo":                         # (E, f, d)
                    return (par.div(tp, shape[-3]), None,
                            par.div(fs, shape[-1]))
            if name in ("wi", "wg"):                     # (E, d, f)
                return (None, par.div(fs, shape[-2]), par.div(tp, shape[-1]))
            if name == "wo":                             # (E, f, d)
                return (None, par.div(tp, shape[-2]), par.div(fs, shape[-1]))
            if name == "router":                         # (d, E)
                return (par.div(fs, shape[-2]), None)
        if name in ("wi", "wg"):                         # (d, f)
            if par.joint_batch:                          # FSDP only
                return (par.div(fs, shape[-2]), None)
            return (par.div(fs, shape[-2]), par.div(tp, shape[-1]))
        if name == "wo":                                 # (f, d)
            if par.joint_batch:
                return (None, par.div(fs, shape[-1]))
            return (par.div(tp, shape[-2]), par.div(fs, shape[-1]))
        if name in ("in_proj", "shared_in"):             # (d, proj)
            return (par.div(fs, shape[-2]), par.div(tp, shape[-1]))
        if name == "out_proj":                           # (d_inner, d)
            return (par.div(tp, shape[-2]), par.div(fs, shape[-1]))
        if name == "conv_w":                             # (K, C)
            return (None, par.div(tp, shape[-1]))
        return tuple(None for _ in shape)                # vectors, norms, A_log…

    b = base()
    pad = len(shape) - len(b)
    if pad < 0:
        raise ValueError(f"spec {b} has more dims than {path} {tuple(shape)}")
    return _spec(*((None,) * pad + tuple(b)))


def _serve_base(name, path, shape, par: Parallelism):
    """Resident-weight decode sharding: no FSDP axis; EP + TP only."""
    tp = par.tp_axis
    ep = "data"          # experts over the data axis (batch is small at decode)
    if name in ("table", "lm_head", "pos_table"):
        return (par.div(tp, shape[-2]), None)
    if name == "wq" or (name in ("wk", "wv")):           # (d, H|KH, hd)
        if shape[-2] % par.axis_size(tp) == 0:
            return (None, tp, None)
        return (None, None, par.div(tp, shape[-1]))      # shard head_dim
    if name == "wo" and len(shape) >= 3 and "'moe'" not in path:
        if shape[-3] % par.axis_size(tp) == 0:           # (H, hd, d)
            return (tp, None, None)
        return (None, par.div(tp, shape[-2]), None)
    if "'moe'" in path:
        if name in ("wi", "wg"):                          # (E, d, f)
            return (par.div(ep, shape[-3]), None, par.div(tp, shape[-1]))
        if name == "wo":                                  # (E, f, d)
            return (par.div(ep, shape[-3]), par.div(tp, shape[-2]), None)
        if name == "router":
            return (None, None)
    if name in ("wi", "wg", "in_proj", "shared_in"):      # (d, f)
        return (None, par.div(tp, shape[-1]))
    if name in ("wo", "out_proj"):                        # (f, d)
        return (par.div(tp, shape[-2]), None)
    if name == "conv_w":
        return (None, par.div(tp, shape[-1]))
    return tuple(None for _ in shape)


def param_pspecs(params, par: Parallelism):
    """Spec tree matching a (real, fake or meta) parameter tree."""
    return tree_map_with_path(
        lambda kp, a: _param_spec(kp, tuple(a.shape), par), params)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------


def to_placements(spec, mesh) -> tuple:
    """One ``Shard(d)`` or ``Replicate()`` per dim of ``mesh`` for ``spec``.

    A tensor dim over several axes (``("pod", "data")``) shards on each of
    their mesh dims, outermost first, as JAX lays a tuple entry out.
    """
    sizes = mesh_sizes(mesh)
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} uses axis {axis!r} twice")
        out.append(Shard(dims[0]) if dims and sizes[axis] > 1
                   else Replicate())
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Placements on a mesh: where one leaf lives (JAX's ``NamedSharding``)."""
    mesh: object
    placements: tuple


def to_shardings(pspecs, mesh):
    """A tree of specs as a tree of ``NamedSharding``."""
    return tree_map(lambda s: NamedSharding(mesh, to_placements(s, mesh)),
                    pspecs)


def param_shardings(params, par: Parallelism):
    return to_shardings(param_pspecs(params, par), par.mesh)


def distribute(t: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``t`` (the same whole tensor on every rank) as a DTensor: each rank
    keeps its own shard, with no communication, in storage of its own (a
    shard that is a view into ``t`` is copied, so ``t`` can be freed)."""
    from torch.distributed.tensor import distribute_tensor
    dt = distribute_tensor(t, sharding.mesh, list(sharding.placements),
                           src_data_rank=None)
    local = dt.to_local()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        dt = DTensor.from_local(local.clone(), sharding.mesh,
                                list(sharding.placements), run_check=False,
                                shape=dt.shape, stride=dt.stride())
    return dt


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------


def _gathered(placements, mesh, fsdp_axis) -> tuple:
    """``placements`` with the FSDP axis's shard replaced by
    ``Replicate()``: a parameter as the compute reads it."""
    names = mesh.mesh_dim_names
    return tuple(Replicate() if names[i] == fsdp_axis else p
                 for i, p in enumerate(placements))


def make_constrain(par: Parallelism, n_heads: int | None = None):
    """``constrain(x, kind)``: ``x`` redistributed to its role's placements.

    The roles and their specs are the reference's ``spec_for`` table.  On
    a plain tensor (one device, ``par=None`` paths) it returns ``x``.  One
    role is the port's own: ``"param"``, a parameter as the compute reads
    it, gathered over the FSDP axis (the reference leaves that gather to
    GSPMD); its gradient is the reduce-scatter back onto the shards.

    ``n_heads``: the model's attention head count; the joint-batch
    attention layout only activates when heads do NOT divide the TP axis.
    """
    dp, tp = par.dp_axes, par.tp_axis
    heads_divisible = (n_heads is None or tp is None
                       or n_heads % par.axis_size(tp) == 0)

    def joint_batch(b):
        axes = tuple(dp) + ((tp,) if tp is not None else ())
        return axes if b % par.axis_size(axes) == 0 else None

    def spec_for(x, kind):
        if kind == "act":            # (B, S, d)
            if par.joint_batch:
                j = joint_batch(x.shape[0])
                if j is not None:
                    return _spec(j, None, None)
            return _spec(par.div(dp, x.shape[0]), None, None)
        if kind == "attn_in":        # (B, S, d) entering attention
            if not heads_divisible:
                j = joint_batch(x.shape[0])
                if j is not None:
                    return _spec(j, None, None)
            return _spec(par.div(dp, x.shape[0]), None, None)
        if kind == "act_ff":         # (B, S, f)
            if par.joint_batch:      # dense FFN keeps the joint batch
                j = joint_batch(x.shape[0])
                if j is not None:
                    return _spec(j, None, None)
            return _spec(par.div(dp, x.shape[0]), None,
                         par.div(tp, x.shape[-1]))
        if kind in ("heads", "kv_heads"):   # (B, S, H, hd)
            if heads_divisible:
                # q heads TP-shard; GQA kv heads (< tp) replicate
                return _spec(par.div(dp, x.shape[0]), None,
                             par.div(tp, x.shape[2]), None)
            # the model's heads don't divide TP: shard the batch over
            # (dp, tp) jointly so attention work still spreads
            j = joint_batch(x.shape[0])
            if j is not None:
                return _spec(j, None, None, None)
            return _spec(par.div(dp, x.shape[0]), None, None, None)
        if kind == "logits":         # (B, chunk, V)
            if par.joint_batch:
                j = joint_batch(x.shape[0])
                if j is not None:
                    return _spec(j, None, None)
            return _spec(par.div(dp, x.shape[0]), None,
                         par.div(tp, x.shape[-1]))
        if kind == "moe_hidden":     # (B, E, C, f)
            if par.joint_batch:      # EP: experts over tp, batch over dp
                return _spec(par.div(dp, x.shape[0]),
                             par.div(tp, x.shape[1]), None, None)
            return _spec(par.div(dp, x.shape[0]), None, None,
                         par.div(tp, x.shape[-1]))
        if kind == "moe_in":         # (B, E, C, d) dispatch tensor
            if par.joint_batch:
                return _spec(par.div(dp, x.shape[0]),
                             par.div(tp, x.shape[1]), None, None)
            return None
        if kind == "moe_out":        # (B, E, C, d) combine tensor
            if par.joint_batch:
                j = joint_batch(x.shape[0])
                if j is not None:
                    return _spec(j, None, None, None)
            return None
        return None

    def constrain(x, kind):
        if not isinstance(x, DTensor):
            return x
        if kind == "param":
            want = _gathered(x.placements, x.device_mesh, par.fsdp_axis)
        else:
            s = spec_for(x, kind)
            if s is None:
                return x
            want = to_placements(s, x.device_mesh)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, list(want))

    constrain.spec_for = spec_for
    return constrain


# ---------------------------------------------------------------------------
# batches and caches
# ---------------------------------------------------------------------------


def batch_pspecs(batch, par: Parallelism):
    def spec(a):
        axes = par.dp_axes
        if par.joint_batch and par.tp_axis is not None:
            joint = tuple(par.dp_axes) + (par.tp_axis,)
            if a.shape[0] % par.axis_size(joint) == 0:
                axes = joint
        return _spec(par.div(axes, a.shape[0]), *(None,) * (a.ndim - 1))
    return tree_map(spec, batch)


def cache_pspecs(cache, par: Parallelism):
    """KV caches (..., B, S, KH, hd) -> batch over dp, sequence over TP.

    SSM states (..., B, H, P, N) -> batch over dp, heads over TP.
    Conv caches (..., B, K-1, C) -> batch over dp, channels over TP.
    """
    dp, tp = par.dp_axes, par.tp_axis

    def spec(name, a):
        if a.ndim >= 4 and ("'k" in name or "'v" in name or "xk" in name
                            or "xv" in name):
            lead = a.ndim - 4
            return _spec(*(None,) * lead, par.div(dp, a.shape[lead]),
                         par.div(tp, a.shape[lead + 1]), None, None)
        if "ssm" in name and a.ndim >= 4:
            lead = a.ndim - 4
            return _spec(*(None,) * lead, par.div(dp, a.shape[lead]),
                         par.div(tp, a.shape[lead + 1]), None, None)
        if "conv" in name and a.ndim >= 3:
            lead = a.ndim - 3
            return _spec(*(None,) * lead, par.div(dp, a.shape[lead]), None,
                         par.div(tp, a.shape[lead + 2]))
        return (None,) * a.ndim

    return tree_map_with_path(spec, cache)
