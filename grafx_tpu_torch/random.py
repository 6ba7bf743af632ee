"""Counter-based random numbers on a threefry2x32 key: the port's own copy
of what :mod:`grafx_tpu` uses from ``jax.random`` (``PRNGKey``,
``fold_in``, ``split``, ``uniform``, ``randint``), bit for bit.

A key is an ``int64`` tensor of shape ``(2,)`` holding the two uint32 words
of a ``jax.random`` legacy key (``jax_default_prng_impl`` "threefry2x32",
``jax_threefry_partitionable`` on: the defaults of JAX 0.9), on the device
of the signals it draws for.  The hash is threefry2x32 written in torch
``int64`` arithmetic masked to 32 bits (add, rotate, xor), so the draws are
the same on the CPU and on the card, and with the same key the same as
``jax.random``'s: a stochastic path of the port can be held against
:mod:`grafx_tpu`'s on the same key (:func:`key_from_numpy` carries a JAX
key across as ``np.asarray(jax_key)``).

Every function runs on the key's device and reads nothing back to the
host, so under a CUDA-graph capture the key is one more tensor argument:
a replay with a new key draws new numbers.
"""

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds) of the counter words ``(x1, x2)``
    under the key words ``(k1, k2)``: int64 tensors holding uint32 values
    (a counter may be a Python int), broadcast together.  Returns the two
    hashed words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def _check_key(key):
    if not isinstance(key, torch.Tensor) or key.dtype != torch.int64 or key.shape != (2,):
        got = (key.dtype, tuple(key.shape)) if isinstance(key, torch.Tensor) else type(key)
        raise ValueError(f"a key is an int64 tensor of shape (2,), got {got}")
    return key


def PRNGKey(seed, device="cpu"):
    """The key of an integer seed, as ``jax.random.PRNGKey(seed)`` makes it
    with 64-bit types off: ``(0, seed mod 2^32)``."""
    if isinstance(seed, bool) or not isinstance(seed, (int, np.integer)):
        raise TypeError(f"a seed is an integer, got {seed!r}")
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def key_from_numpy(key, device="cpu"):
    """A key from the two uint32 words of a ``jax.random`` key
    (``np.asarray(jax_key)``), or any array of two integers in [0, 2^32)."""
    words = np.asarray(key)
    if words.shape != (2,) or not np.issubdtype(words.dtype, np.integer):
        raise ValueError(f"a key is two integer words, got {words.dtype} {words.shape}")
    words = words.astype(np.int64)
    if (words < 0).any() or (words > _MASK).any():
        raise ValueError(f"key words must lie in [0, 2^32), got {words.tolist()}")
    return torch.tensor(words, dtype=torch.int64, device=device)


def key_to_numpy(key):
    """The key's two words as a uint32 numpy array (``jax.random``'s
    layout)."""
    return _check_key(key).cpu().numpy().astype(np.uint32)


def _counters(shape, device):
    """``iota_2x32_shape``: the flat index of each element of ``shape`` as
    (high, low) words (below 2^32 elements, the high word is 0)."""
    size = 1
    for s in shape:
        size *= s
    if size >= 2**32:
        raise ValueError(f"draws of {size} elements are not supported")
    lo = torch.arange(size, dtype=torch.int64, device=device).reshape(shape)
    return torch.zeros_like(lo), lo


def _bits(key, shape):
    """32 random bits a element: ``jax.random.bits(key, shape, uint32)``."""
    k1, k2 = _check_key(key).unbind(0)
    hi, lo = _counters(tuple(shape), key.device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1 ^ b2


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: a new key from ``key`` and the
    integer ``data`` (taken mod 2^32)."""
    k1, k2 = _check_key(key).unbind(0)
    # data as a Python int: no host tensor is copied to the key's device
    b1, b2 = threefry2x32(k1, k2, 0, int(data) & _MASK)
    return torch.stack([b1, b2])


def split(key, num=2):
    """``jax.random.split(key, num)``: ``(*shape, 2)`` keys, ``num`` an
    integer or a shape."""
    shape = tuple(num) if isinstance(num, (tuple, list)) else (int(num),)
    k1, k2 = _check_key(key).unbind(0)
    hi, lo = _counters(shape, key.device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=-1)


def uniform(key, shape=(), minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape)`` in float32: the top 23 bits of
    each draw as the mantissa of a float in [1, 2), less 1, scaled."""
    bits = _bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats * (maxval - minval) + minval, minval)


def _mul32(a, b):
    """``a * b mod 2^32`` for uint32 values in int64 without overflow (``b``
    a tensor or a Python int)."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    cross = (a_hi * b_lo + a_lo * b_hi) & 0xFFFF
    return (a_lo * b_lo + (cross << 16)) & _MASK


def randint(key, shape, minval, maxval):
    """``jax.random.randint(key, shape, minval, maxval)`` in int32 for
    integer bounds in the int32 range: two 32-bit draws from the two keys
    of ``split(key)`` reduced mod ``maxval - minval`` as ``jax.random``
    reduces them (a span of 1 where ``maxval <= minval``).  Returns an
    int64 tensor."""
    for v in (minval, maxval):
        if isinstance(v, bool) or not isinstance(v, (int, np.integer)):
            raise TypeError(f"randint bounds are integers, got {v!r}")
        if not -(2**31) <= int(v) < 2**31:
            raise ValueError(f"randint bounds lie in the int32 range, got {v}")
    minval, maxval = int(minval), int(maxval)
    k1, k2 = split(key).unbind(0)
    higher, lower = _bits(k1, shape), _bits(k2, shape)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    # 2^32 mod span, in uint32 arithmetic as jax.random forms it
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & _MASK) % span
    offset = (_mul32(higher % span, multiplier) + lower % span) & _MASK
    return minval + offset % span
