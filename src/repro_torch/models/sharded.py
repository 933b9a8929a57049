"""The model layer's explicit redistributions under DTensor.

Under a ``Parallelism`` the parameters, the batch and the caches are
DTensors, and most ops of the model run on them as they are: DTensor
propagates the placements (``constrain`` sets them at the reference's
``with_sharding_constraint`` points).  The ops below have no DTensor
rule, or none that keeps the work spread, so the model calls these
helpers there and each names its collective.  On plain tensors every
helper is the identity or the plain op, so the one-device path is
unchanged.

* ``replicate``/``whole``: a tensor (or one dim of it) gathered, where a
  slice or an elementwise op would otherwise redistribute it implicitly
  (the SSD block's split of ``in_proj``'s TP-sharded output and its conv
  parameters; ``chunked_ce``'s vocab-sharded logits before the
  log-sum-exp and the label pick).
* ``local_heads``: attention on each rank's own batch rows and heads
  (flash's block loop and the decode attention reshape a sharded head dim
  into (kv heads, group) and loop over blocks, which DTensor would turn
  into thousands of redistributions).  A sequence-sharded KV cache is
  gathered over its sequence first.
* ``local_rows``: a function of whole batch rows on each rank's rows: MoE
  routing, dispatch and combine (``sort``, ``searchsorted``,
  ``scatter_``, ``gather`` by computed indices); the SSD block between
  its projections (its chunk reshapes of a TP-sharded gradient and its
  ``cumsum`` scan leave DTensor's backward without a rule); and the
  cross-entropy's label pick (the backward of ``gather`` and of a slice
  make a replicated zero tensor of the global shape under DTensor).
* ``experts_local``: expert parallelism, the experts' inputs moved to
  the ranks that hold their weights (the decode profile shards experts
  over ``data``, where the tokens are split by batch).
* ``write_slot``: the decode's KV-cache write at one position of a
  sequence-sharded cache, on the rank that holds it.
* ``write_at``: a decode's write of one layer's state at leading indices
  of a stacked cache whose indexed dims may be sharded (the hybrid's
  conv cache: the reference's rule takes any ``ssm`` leaf of 4 dims or
  more for a state and shards its second dim), on the rank that holds it.
* ``embedding``: the lookup in a vocabulary-sharded table, Megatron's
  vocabulary-parallel embedding: each rank its own rows, one all-reduce
  (DTensor's own rule leaves a masked partial sum whose backward it
  cannot redistribute).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def is_dt(x) -> bool:
    return isinstance(x, DTensor)


def _redistribute(x, placements):
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, list(placements))


def replicate(x):
    """``x`` whole on every rank (an all-gather or all-reduce)."""
    if not is_dt(x):
        return x
    return _redistribute(x, [Replicate()] * x.device_mesh.ndim)


def whole(x, dim: int):
    """``x`` with dim ``dim`` unsharded and no pending reduction."""
    if not is_dt(x):
        return x
    dim = dim % x.ndim
    return _redistribute(x, [
        Replicate() if isinstance(p, Partial) or
        (isinstance(p, Shard) and p.dim == dim) else p
        for p in x.placements])


def _only(x, dims):
    """``x`` sharded on tensor dims ``dims`` at most, with no pending
    reduction (other shards gathered)."""
    return _redistribute(x, [
        p if isinstance(p, Shard) and p.dim in dims else Replicate()
        if isinstance(p, (Shard, Partial)) else p for p in x.placements])


def _wrap(local, like_placements, mesh, shape):
    return DTensor.from_local(local, mesh, list(like_placements),
                              run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape):
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def local_rows(fn, x, *rest, out_shape):
    """``fn(x_local, *rest_local)`` on each rank's batch rows.

    ``x`` (a tensor, or a tuple of tensors placed alike) is batch-sharded
    (dim 0) at most, other shards gathered; ``fn`` computes row by row,
    so each of its outputs has the rows of ``x``'s shard.  ``rest`` are
    trees of tensors every row uses (the parameters of the block): each
    rank takes them whole, and their gradient is a partial sum over the
    mesh dims that split the batch.  ``out_shape`` is the global shape of
    ``fn``'s output, or a tuple of shapes for a tuple of outputs.
    """
    xs = x if isinstance(x, tuple) else (x,)
    if not is_dt(xs[0]):
        return fn(*xs, *rest)
    from torch.utils._pytree import tree_map
    lead = _only(xs[0], (0,))
    placements, mesh = lead.placements, lead.device_mesh
    xs = [lead] + [_redistribute(t, placements) for t in xs[1:]]
    grad = [Partial() if isinstance(p, Shard) else Replicate()
            for p in placements]

    def whole_local(t):
        if not is_dt(t):
            return t
        return replicate(t).to_local(grad_placements=grad)
    out = fn(*(t.to_local() for t in xs), *tree_map(whole_local, rest))
    if isinstance(out, tuple):
        return tuple(_wrap(o, placements, mesh, s)
                     for o, s in zip(out, out_shape))
    return _wrap(out, placements, mesh, out_shape)


def experts_local(h, w):
    """``h (B, E, ...)`` placed for an expert product with ``w (E, ...)``:
    on a mesh dim that shards ``w``'s experts, ``h`` takes its experts
    sharded too (an all-to-all from its batch split), so each rank runs
    its own experts (expert parallelism).  Returns ``(h, back)``, ``back``
    the redistribution of a result to ``h``'s placements as it came."""
    if not (is_dt(h) and is_dt(w)):
        return h, lambda y: y
    was = tuple(h.placements)
    want = [Shard(1) if isinstance(pw, Shard) and pw.dim == 0 else ph
            for ph, pw in zip(was, w.placements)]
    return _redistribute(h, want), lambda y: _redistribute(y, was)


def local_heads(fn, q, k, v):
    """``fn(q, k, v) -> out`` (attention; q (B,Sq,H,D), k/v (B,Sk,KH,D),
    out shaped like q) on each rank's batch rows and query heads.

    Per mesh dim: q sharded on batch takes k/v sharded alike; q sharded on
    heads takes k/v sharded on heads when the kv heads divide that mesh
    dim, else k/v whole there, and each rank slices the kv heads of its
    own query heads (their gradient is then a partial sum over the dim).
    A sequence-sharded k/v (a decode cache) is gathered over the sequence.
    """
    if not is_dt(q):
        return fn(q, k, v)
    mesh = q.device_mesh
    H, KH = q.shape[2], k.shape[2]
    G = H // KH
    q = _only(q, (0, 2))
    kp, kv_grad, slice_dim = [], [], None
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if isinstance(p, Shard) and p.dim == 2 and KH % n:
            if slice_dim is not None or (H // n) % G and G % (H // n):
                # the local heads do not group over whole kv heads: the
                # query heads are gathered on this dim instead
                q = _redistribute(q, [Replicate() if j == i else pq
                                      for j, pq in enumerate(q.placements)])
                kp.append(Replicate())
                kv_grad.append(Replicate())
                continue
            slice_dim = i
            kp.append(Replicate())
            kv_grad.append(Partial())
        else:
            kp.append(p)
            kv_grad.append(p)
    k = _redistribute(k, kp)
    v = _redistribute(v, kp)
    ql = q.to_local()
    kl = k.to_local(grad_placements=kv_grad)
    vl = v.to_local(grad_placements=kv_grad)
    if slice_dim is not None:
        h_loc = ql.shape[2]
        h0 = mesh.get_local_rank(slice_dim) * h_loc
        k0, k1 = h0 // G, (h0 + h_loc - 1) // G + 1
        kl, vl = kl[:, :, k0:k1], vl[:, :, k0:k1]
    out = fn(ql, kl, vl)
    return _wrap(out, q.placements, mesh, tuple(q.shape))


def write_slot(cache, slot: int, val) -> None:
    """``cache[:, slot] = val`` in place, for ``cache (B, S, ...)`` and
    ``val (B, ...)``; on a sequence-sharded cache only the rank holding
    position ``slot`` writes, into its own shard."""
    if not is_dt(cache):
        cache[:, slot] = val
        return
    mesh = cache.device_mesh
    # val takes the cache's placements with the sequence dim dropped
    vp, seq_dims = [], []
    for i, p in enumerate(cache.placements):
        if isinstance(p, Shard) and p.dim == 1:
            seq_dims.append(i)
            vp.append(Replicate())
        elif isinstance(p, Shard):
            vp.append(Shard(p.dim - (p.dim > 1)))
        else:
            vp.append(p)
    local_val = _redistribute(val, vp).to_local()
    local = cache.to_local()
    lo = 0
    S = cache.shape[1]
    for i in seq_dims:              # torch.chunk's split, dim by dim
        n = mesh.size(i)
        chunk = -(-S // n)
        lo += mesh.get_local_rank(i) * chunk
        S = min(chunk, max(S - mesh.get_local_rank(i) * chunk, 0))
    if lo <= slot < lo + local.shape[1]:
        local[:, slot - lo] = local_val


def write_at(cache, idx: tuple, val) -> None:
    """``cache[idx] = val`` in place for integer indices ``idx`` of the
    leading dims; on a DTensor whose indexed dims are sharded only the
    rank holding the element writes, into its own shard (DTensor's own
    ``__setitem__`` writes each rank's local index instead)."""
    if not is_dt(cache):
        cache[idx] = val
        return
    mesh, n = cache.device_mesh, len(idx)
    if not is_dt(val):
        val = DTensor.from_local(val, mesh, [Replicate()] * mesh.ndim)
    vp, lo, size = [], [0] * n, list(cache.shape[:n])
    for i, p in enumerate(cache.placements):
        if isinstance(p, Shard) and p.dim < n:
            chunk = -(-size[p.dim] // mesh.size(i))   # torch.chunk's split
            r = mesh.get_local_rank(i)
            lo[p.dim] += r * chunk
            size[p.dim] = min(chunk, max(size[p.dim] - r * chunk, 0))
            vp.append(Replicate())
        elif isinstance(p, Shard):
            vp.append(Shard(p.dim - n))
        else:
            vp.append(p)
    local_val = _redistribute(val, vp).to_local()
    if all(0 <= i - l < s for i, l, s in zip(idx, lo, size)):
        cache.to_local()[tuple(i - l for i, l in zip(idx, lo))] = local_val


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward: the partial lookups of
    a vocabulary-parallel embedding summed; every rank then computes on
    the same whole value, so each takes the whole gradient as it is."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def embedding(tokens, table):
    """``table[tokens]``; on a DTensor table sharded over the vocabulary,
    each rank looks up the tokens of its rows, zeros elsewhere, and one
    all-reduce over that mesh dim sums them."""
    if not is_dt(table):
        return table[tokens]
    mesh = table.device_mesh
    if not is_dt(tokens):
        tokens = DTensor.from_local(tokens, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    tokens = _only(tokens, (0,))
    # a mesh dim that shards both the batch and the vocabulary gathers
    # the table there
    table = _redistribute(table, [
        Replicate() if isinstance(p, Partial) or (
            isinstance(p, Shard) and (p.dim != 0 or tokens.placements[i]
                                      != Replicate())) else p
        for i, p in enumerate(table.placements)])
    vocab = [i for i, p in enumerate(table.placements) if isinstance(p, Shard)]
    grad = [Shard(0) if i in vocab else
            Partial() if isinstance(tokens.placements[i], Shard) else
            Replicate() for i in range(mesh.ndim)]
    tl = tokens.to_local()
    t = table.to_local(grad_placements=grad)
    if vocab:
        V = table.shape[0]
        lo, n = 0, V
        for i in vocab:             # torch.chunk's split, dim by dim
            chunk = -(-n // mesh.size(i))
            lo += mesh.get_local_rank(i) * chunk
            n = t.shape[0]
        inside = (tl >= lo) & (tl < lo + t.shape[0])
        x = t[torch.where(inside, tl - lo, 0)] * inside[..., None].to(t.dtype)
        for i in vocab:
            x = _SumOverGroup.apply(x, mesh.get_group(i))
    else:
        x = t[tl]
    shape = (*tokens.shape, table.shape[1])
    return _wrap(x, tokens.placements, mesh, shape)
