"""Counter-based threefry2x32 randomness, bit-identical to ``jax.random``.

The port draws every random number the way jax does with its default
``jax_threefry_partitionable=True``: a key is two uint32 words, ``fold_in``
hashes a 32-bit counter into it, ``split`` hashes the 64-bit iota ``0..num-1``
and ``bits`` hashes the flat 64-bit iota over the output shape (one threefry
block per element, 32-bit draws being ``x0 ^ x1`` and 64-bit draws
``x0 << 32 | x1``). So a stream seeded the same way reproduces the JAX
reference's estimator state exactly, on any device.

Representation: a key is an int64 tensor of shape ``(..., 2)`` holding the two
uint32 words (values in ``[0, 2**32)``); leading axes batch independent keys,
the way ``jax.vmap`` batches them in the reference. All arithmetic runs in
int64 and is masked back to 32 bits after every add, so the same code runs on
CPU and CUDA tensors (PyTorch has no general uint32/uint64 arithmetic).
uint64 draws are carried as the int64 with the same bits; the unsigned
remainder that ``randint`` needs is emulated by ``_urem64``.

A key on the ``meta`` device draws shapes only: every draw returns an empty
``meta`` tensor of the draw's shape and dtype and runs no threefry (the
counterpart of ``jax.eval_shape``), so ``init_params(meta_key, cfg)`` is a
walk over the params' shapes that allocates nothing. Draws on a real device
are untouched by it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

Tensor = torch.Tensor
M32 = 0xFFFFFFFF
INT64_MAX = 0x7FFFFFFFFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x0, x1) -> tuple[Tensor, Tensor]:
    """The threefry-2x32 block (20 rounds) on broadcastable int64 tensors
    carrying uint32 values; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _shape_only(key: Tensor, shape, dtype) -> Tensor:
    """The result of a draw from a ``meta`` key: empty, on ``meta``, with the
    key's leading axes and then ``shape``."""
    return torch.empty(tuple(key.shape[:-1]) + tuple(shape), dtype=dtype, device="meta")


def PRNGKey(seed: int, device: Union[str, torch.device] = "cpu") -> Tensor:
    """``jax.random.PRNGKey(seed)``: the 64-bit seed's (hi, lo) words."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([s >> 32, s & M32], dtype=torch.int64, device=device)


def fold_in(key: Tensor, data: Union[int, Tensor]) -> Tensor:
    """``jax.random.fold_in``: ``data`` is taken mod 2**32, like jax's
    uint32 cast. A tensor ``data`` of shape (n,) folds n counters into one
    key, giving (n, 2) keys (the reference's ``vmap(fold_in)``)."""
    if key.is_meta:
        n = tuple(data.shape) if isinstance(data, Tensor) else ()
        return _shape_only(key, n + (2,), torch.int64)
    if isinstance(data, Tensor):
        d = data.to(device=key.device, dtype=torch.int64) & M32
        k = key.unsqueeze(-2) if d.dim() else key
    else:
        d = torch.tensor(int(data) & M32, dtype=torch.int64, device=key.device)
        k = key
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(key: Tensor, num: int = 2) -> Tensor:
    """``jax.random.split`` (partitionable): (..., 2) -> (..., num, 2)."""
    if key.is_meta:
        return _shape_only(key, (num, 2), torch.int64)
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(
        key[..., 0, None], key[..., 1, None], torch.zeros_like(lo), lo
    )
    return torch.stack([y0, y1], dim=-1)


def _block(key: Tensor, shape: tuple[int, ...], offset: int = 0) -> tuple[Tensor, Tensor]:
    """Threefry blocks of the counters ``offset .. offset + n - 1`` (n the
    shape's size): elements ``offset ..`` of a longer draw from the same key,
    so a shard holding estimators ``[o, o + r_local)`` draws its slice of
    the full-r draw with ``offset=o``."""
    if key.is_meta:
        y = _shape_only(key, shape, torch.int64)
        return y, y
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(int(offset), int(offset) + n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,))
    k2 = key[..., 1].reshape(lead + (1,))
    y0, y1 = threefry2x32(k1, k2, idx >> 32, idx & M32)
    return y0.reshape(lead + tuple(shape)), y1.reshape(lead + tuple(shape))


def bits32(key: Tensor, shape: tuple[int, ...], offset: int = 0) -> Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in [0, 2**32);
    ``offset`` starts the draw at that element of a longer one (``_block``)."""
    y0, y1 = _block(key, shape, offset)
    return y0 ^ y1


def bits64(key: Tensor, shape: tuple[int, ...], offset: int = 0) -> Tensor:
    """``jax.random.bits(key, shape, uint64)``, carried as the int64 with the
    same bits."""
    y0, y1 = _block(key, shape, offset)
    return (y0 << 32) | y1


def uniform(key: Tensor, shape: tuple[int, ...], offset: int = 0,
            minval: Optional[float] = None, maxval: Optional[float] = None) -> Tensor:
    """``jax.random.uniform(key, shape, float32)`` on [0, 1): the top 23 bits
    as the mantissa of a float in [1, 2), minus 1. With ``minval`` and
    ``maxval`` (numbers, rounded to float32 as jax converts them), jax's
    ``max(minval, u * (maxval - minval) + minval)``, whose multiply and add
    XLA fuses into one rounding (an FMA): it is computed in float64 and
    rounded once to float32, which is that FMA wherever the float64 sum is
    exact, as it is for the initialisers' range ``-maxval .. maxval`` (u
    has 23 bits after the point, the span 24 significant bits)."""
    if key.is_meta:
        return _shape_only(key, shape, torch.float32)
    b = (bits32(key, shape, offset) >> 9) | 0x3F800000
    u = b.to(torch.int32).view(torch.float32) - 1.0
    if minval is None:
        return u
    lo = torch.tensor(minval, dtype=torch.float32, device=u.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=u.device)
    span = (hi - lo).double()
    return torch.maximum(lo, (u.double() * span + lo.double()).float())


def uniform64(key: Tensor, shape: tuple[int, ...], offset: int = 0) -> Tensor:
    """``jax.random.uniform(key, shape, float64)`` on [0, 1), the default
    dtype under x64: the top 52 bits of a 64-bit draw as the mantissa of a
    float in [1, 2), minus 1 (the shift is logical, hence the mask)."""
    b = ((bits64(key, shape, offset) >> 12) & ((1 << 52) - 1)) | 0x3FF0000000000000
    return b.view(torch.float64) - 1.0


def span_offset32(hi: Tensor, lo: Tensor, span: Tensor) -> Tensor:
    """jax's ``randint`` span arithmetic in uint32: ``((hi % span) * m +
    lo % span) % span`` with ``m = (2**16 % span)**2 % span``, where the
    product and the sum wrap at 2**32. All arguments are int64 tensors with
    values in [0, 2**32), ``span >= 1``; the result is int64 in [0, span)."""
    mult = 65536 % span
    mult = ((mult * mult) & M32) % span
    off = (((hi % span) * mult) & M32) + (lo % span)
    return (off & M32) % span


def _urem64(x: Tensor, d: Tensor) -> Tensor:
    """Unsigned 64-bit ``x % d`` for x carried as int64 bits and 0 < d < 2**63.

    The top bit is split off: x = x' + 2**63 * t with x' = x & INT64_MAX, so
    x % d = (x' % d + t * (2**63 % d)) % d, and both terms are below d, so the
    final reduction is one conditional subtraction that cannot overflow."""
    a = torch.remainder(x & INT64_MAX, d)
    top = torch.remainder(torch.remainder(torch.full_like(d, INT64_MAX), d) + 1, d)
    b = torch.where(x < 0, top, torch.zeros_like(top))
    over = a - (d - b)
    return torch.where(over >= 0, over, a + b)


def randint32(key: Tensor, maxval: Union[int, Tensor], shape: tuple[int, ...],
              offset: int = 0, minval: Union[int, Tensor] = 0) -> Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)`` with a span
    per lane (``minval`` and ``maxval`` broadcast to ``shape``): the span is
    ``maxval - minval``, 1 where that is not positive, and ``minval`` is
    added to the offset drawn in it; int32 result."""
    if key.is_meta:
        return _shape_only(key, shape, torch.int32)
    k = split(key)
    hi = bits32(k[..., 0, :], shape, offset)
    lo = bits32(k[..., 1, :], shape, offset)
    if not isinstance(maxval, Tensor):  # a Python int stays on the host: no upload
        maxval = torch.full_like(hi, int(maxval))
    shifted = isinstance(minval, Tensor) or minval != 0  # no extra op on the estimator's path
    span = maxval.to(torch.int64)
    if shifted:
        span = span - (minval.to(torch.int64) if isinstance(minval, Tensor) else int(minval))
    span = torch.where(span <= 0, torch.ones_like(span), span)
    off = span_offset32(hi, lo, span)
    return (off + minval if shifted else off).to(torch.int32)


def randint64(key: Tensor, maxval: Tensor, shape: tuple[int, ...],
              offset: int = 0) -> Tensor:
    """``jax.random.randint(key, shape, 0, maxval, int64)``: the same
    two-draw construction over 64-bit words, with wrapping int64 ``*``/``+``
    and the unsigned remainder emulated by ``_urem64``."""
    k = split(key)
    hi = bits64(k[..., 0, :], shape, offset)
    lo = bits64(k[..., 1, :], shape, offset)
    maxval = maxval.to(torch.int64)
    span = torch.where(maxval <= 0, torch.ones_like(maxval), maxval)
    span = span.expand(hi.shape)
    mult = torch.remainder(torch.full_like(span, 1 << 32), span)
    mult = _urem64(mult * mult, span)
    off = _urem64(hi, span) * mult + _urem64(lo, span)
    return _urem64(off, span)
