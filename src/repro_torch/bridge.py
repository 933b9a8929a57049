"""Carry simulation state and model weights between numpy and the port.

A burned-in ensemble from the JAX reference (a ``SimState`` as numpy
arrays) continues in the port, and back, bit for bit.  A threefry key
crosses the same way (``jax.random.key_data`` as numpy in, the port's key
out), so the port can continue a JAX key's stream.  A language model's
parameter tree (``DecoderModel.init``'s, as numpy) loads into the port's
module, and back (``lm_params_from_numpy``, ``lm_params_to_numpy``); so
does a training state, ``{"params", "opt": {"m", "v", "count"}, "step"}``
(``train_state_from_numpy``, ``train_state_to_numpy``).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.events import MASK32
from .core.horizon import SimState
from .device import resolve_device


def state_from_numpy(tau, offset, offset_comp, step, device=None) -> SimState:
    """A port ``SimState`` on ``device`` (``None`` = GPU) from numpy arrays.

    ``tau`` is ``(B, L)``, ``offset``/``offset_comp`` ``(B,)``, all float32;
    ``step`` is the parallel step index.
    """
    dev = resolve_device(device)
    tau = np.array(tau, np.float32)
    offset = np.array(offset, np.float32)
    offset_comp = np.array(offset_comp, np.float32)
    if tau.ndim != 2 or offset.shape != (tau.shape[0],) or \
            offset_comp.shape != offset.shape:
        raise ValueError(f"need tau (B, L) and offsets (B,), got "
                         f"{tau.shape}, {offset.shape}, {offset_comp.shape}")
    return SimState(*(torch.as_tensor(a, device=dev)
                      for a in (tau, offset, offset_comp)), int(step))


def state_to_numpy(state: SimState):
    """``(tau, offset, offset_comp, step)`` of a port state, as numpy."""
    return (*(state_field.detach().cpu().numpy() for state_field in
              (state.tau, state.offset, state.offset_comp)), int(state.step))


def key_from_numpy(data, device=None) -> torch.Tensor:
    """The port's threefry key (``core.prng``) on ``device`` (``None`` = GPU)
    from a JAX key's ``key_data``: two uint32 words."""
    words = np.asarray(data)
    if words.shape != (2,) or words.dtype.kind not in "iu":
        raise ValueError(f"key data must be two integer words, got "
                         f"{words.shape} {words.dtype}")
    return torch.as_tensor(words.astype(np.int64) & MASK32,
                           device=resolve_device(device))


def _flat(tree, prefix=""):
    """``{"a/b/c": leaf}`` of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _module_leaves(model) -> dict:
    return {name.replace(".", "/"): t
            for name, t in model.params.named_parameters()}


def _tensor_of(a) -> torch.Tensor:
    """A numpy array (``ml_dtypes.bfloat16`` included) as a CPU tensor."""
    a = np.array(a)                          # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_numpy(model, tree) -> None:
    """Load a JAX ``DecoderModel.init`` tree (nested dicts of numpy arrays,
    e.g. ``jax.tree.map(np.asarray, params)``) into the port's ``model``,
    in place, on the model's device.

    Every leaf must match one of the model's parameters in path, shape and
    dtype; a missing or extra leaf raises.
    """
    theirs = _flat(tree)
    ours = _module_leaves(model)
    if set(theirs) != set(ours):
        raise ValueError(
            f"parameter trees differ: missing {sorted(set(ours) - set(theirs))}"
            f", extra {sorted(set(theirs) - set(ours))}")
    for name, param in ours.items():
        t = _tensor_of(theirs[name])
        if t.shape != param.shape or t.dtype != param.dtype:
            raise ValueError(f"{name}: got {tuple(t.shape)} {t.dtype}, the "
                             f"model has {tuple(param.shape)} {param.dtype}")
    with torch.no_grad():
        for name, param in ours.items():
            param.copy_(_tensor_of(theirs[name]))


def lm_params_to_numpy(model) -> dict:
    """The model's parameter tree as nested dicts of numpy arrays, in the
    reference's layout; bfloat16 leaves come back as float32 (exact)."""
    out = {}
    for name, t in _module_leaves(model).items():
        *path, leaf = name.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        t = t.detach().cpu()
        node[leaf] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


def train_state_from_numpy(model, tree) -> dict:
    """The port's training state of ``model`` from a JAX one as numpy
    (``jax.tree.map(np.asarray, state)``): the parameters are loaded into
    the module in place (``lm_params_from_numpy``) and the state holds
    them; the moments are new tensors of the parameters' dtypes on the
    model's device, ``count`` and ``step`` int32."""
    from .train.train_step import init_train_state
    lm_params_from_numpy(model, tree["params"])
    state = init_train_state(model)
    ours = _flat(state["opt"]["m"])
    with torch.no_grad():
        for part in ("m", "v"):
            theirs = _flat(tree["opt"][part])
            if set(theirs) != set(ours):
                raise ValueError(f"opt/{part} differs from the parameters")
            for name, t in _flat(state["opt"][part]).items():
                t.copy_(_tensor_of(theirs[name]).to(t.dtype))
        for t, a in ((state["opt"]["count"], tree["opt"]["count"]),
                     (state["step"], tree["step"])):
            t.fill_(int(np.asarray(a)))
    return state


def train_state_to_numpy(state) -> dict:
    """A training state as nested dicts of numpy arrays in the reference's
    layout (bfloat16 leaves as float32, exact)."""
    def host(t):
        t = t.detach().to("cpu", copy=True)         # never the live tensor
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else host(v)
                for k, v in tree.items()}
    return walk(state)
