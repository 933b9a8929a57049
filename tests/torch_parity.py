"""Helpers shared by the tests that hold ``repro_torch`` against ``repro``.

Imported by ``tests/test_torch_*.py`` (pytest puts this directory on the
path); not a test module itself.
"""
import functools

import numpy as np
import torch

#: moments (and the StepStats built from them) that must agree bit for bit;
#: the sums agree only to rounding, because the reduction order differs.
EXACT_MOMENTS = ("ucount", "min", "max")
EXACT_STATS = ("utilization", "gvt")
RTOL = 1e-5


@functools.cache
def jax_eta_table() -> np.ndarray:
    """JAX's η for all ``2**24`` decode inputs ``k << 8`` (64 MiB of fp32).

    Built under ``jax.jit``, as the reference's kernel bodies are compiled;
    returned writable, so ``torch.as_tensor`` shares it without a copy.
    """
    import jax
    import jax.numpy as jnp
    from repro.core.horizon import decode_words
    w1 = np.arange(1 << 24, dtype=np.uint32) << 8
    fn = jax.jit(lambda w: decode_words(jnp.zeros_like(w), w, 1,
                                        jnp.float32)[2])
    return np.array(fn(jnp.asarray(w1)))


def np_of(x) -> np.ndarray:
    """A JAX array, torch tensor or numpy array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_moments(port: dict, ref: dict, msg="") -> None:
    """Kernel moment dicts: exact keys bitwise, sums to ``RTOL``."""
    assert set(port) == set(ref), (list(port), list(ref))
    for k in ref:
        a, b = np_of(port[k]), np_of(ref[k])
        if k in EXACT_MOMENTS:
            np.testing.assert_array_equal(a, b, err_msg=f"{msg}{k}")
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6,
                                       err_msg=f"{msg}{k}")


def assert_stats(port, ref, msg="") -> None:
    """StepStats: utilization and gvt bitwise, the rest to ``RTOL``."""
    for f in ref._fields:
        a, b = np_of(getattr(port, f)), np_of(getattr(ref, f))
        if f in EXACT_STATS:
            np.testing.assert_array_equal(a, b, err_msg=f"{msg}{f}")
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-5,
                                       err_msg=f"{msg}{f}")
