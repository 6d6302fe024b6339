"""Primitive layers as functions on tensors.

Numerics follow ``realise_tpu.ops.layers``: parameters are stored in float32
and cast down to the activation dtype at the matmul, the matmul output is in
that dtype and the bias is added in it; layer norm runs in float32 whatever
the activation dtype. Weights keep torch's (out, in) layout. Dropout is the
counter-hash dropout of ``realise_tpu.ops.layers.dropout``, bit for bit;
``table_gather`` is the row gather of the factorized streams with a
float32, deterministic backward.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

M32 = 0xFFFFFFFF
Int32Like = Union[int, torch.Tensor]


def mul32(h: Int32Like, c: int) -> Int32Like:
    """``h * c mod 2**32`` for uint32 values held in int64 tensors (or Python
    ints), split in 16-bit halves so that no int64 product overflows."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & M32


def mix32(h: Int32Like) -> Int32Like:
    """murmur3 fmix32 over uint32 values (int64 tensors or Python ints)."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def global_index(shape: Sequence[int], global_shape: Sequence[int],
                 offsets: Sequence[int], device=None) -> torch.Tensor:
    """The row-major index in an array of ``global_shape`` of every element
    of its block of ``shape`` that starts at ``offsets``."""
    idx = torch.zeros((), dtype=torch.int64, device=device)
    for n, g, o in zip(shape, global_shape, offsets):
        idx = idx[..., None] * g + (torch.arange(n, dtype=torch.int64,
                                                 device=device) + o)
    return idx


def dropout(x: torch.Tensor, rate: float, key: Tuple[int, int],
            layout: Optional[Tuple[Sequence[int], Sequence[int]]] = None
            ) -> torch.Tensor:
    """Counter-hash dropout: element ``i`` is kept when the top 24 bits of
    ``mix32(base ^ mix32(i))`` fall under ``keep * 2**24``, and kept values
    are ``x / keep``. ``key``: two uint32 words, the words JAX reads from a
    key with ``jax.random.key_data`` (the JAX function gives the same mask
    for the same words). ``layout``: (global shape, offsets) when ``x`` is
    one rank's block of a larger array (tensor parallelism): ``i`` is then
    the element's index in that array, as GSPMD partitions the JAX
    function's global ``iota``, so the ranks' masks are the blocks of the
    one-process mask."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    k0, k1 = (int(k) & M32 for k in key)
    base = mix32(k1 ^ mix32(k0 ^ 0x9E3779B1))
    if layout is None:
        idx = torch.arange(x.numel(), dtype=torch.int64, device=x.device)
    else:
        idx = global_index(x.shape, *layout, device=x.device)
    bits = mix32(base ^ mix32(idx))
    mask = (bits >> 8) < min(int(keep * (1 << 24)), 1 << 24)
    return torch.where(mask.reshape(x.shape), x / keep, torch.zeros_like(x))


class StreamGenerator(torch.Generator):
    """A host generator of dropout keys and seeds for one of several
    streams: every rank of a data-parallel run holds the same generator
    state (one checkpoint restores them all) and draws the same values, and
    :func:`stream_value` mixes the rank in, as the JAX shard_map step folds
    ``axis_index("data")`` into its key (trainer.py:182-184). Stream 0 draws
    exactly what a plain ``torch.Generator`` of the same seed draws; every
    rank of a tensor-parallel run draws it, as the GSPMD step has one key
    (trainer.py:135-136), and places its blocks by ``dropout``'s layout."""

    stream = 0


def dropout_generator(seed: int, stream: int = 0) -> torch.Generator:
    """A :class:`StreamGenerator` seeded with ``seed`` for ``stream``."""
    gen = StreamGenerator()
    gen.stream = stream
    gen.manual_seed(seed)
    return gen


def stream_value(value: int, generator: torch.Generator, modulus: int) -> int:
    """``value`` drawn from ``generator``, moved to its stream (unchanged on
    stream 0 and for a plain generator), still in ``[0, modulus)``."""
    stream = getattr(generator, "stream", 0)
    if not stream:
        return value
    return (value + mix32(stream) + stream * 0x9E3779B1) % modulus


def random_key(generator: torch.Generator) -> Tuple[int, int]:
    """Two uint32 key words drawn on the host from ``generator`` (the first
    moved to the generator's stream)."""
    words = torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                          generator=generator)
    return stream_value(int(words[0]), generator, 1 << 32), int(words[1])


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T + bias`` with the mixed-precision rule: the weight and
    the bias are cast to x's dtype, the product is rounded to it and the bias
    is added in it."""
    return torch.matmul(x, weight.to(x.dtype).t()) + bias.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm computed in float32 regardless of the activation dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def embed(table: torch.Tensor, ids: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """The rows ``ids`` of a float32 embedding table, cast to ``dtype``; the
    table's gradient is :func:`table_gather`'s."""
    return table_gather(table, ids).to(dtype)


# Tables of at most this many rows (the two token types, the 33 pinyin
# symbols, the 512 positions) take their gradient as a one-hot matmul. On
# the card ``embedding_dense_backward`` gave such tables different bits
# from one call to the next (tools/determinism_probe.py: the token types
# and pinyin symbols at B=32 and 256, the positions at B=256), and the
# port's loss trace then differed from run to run; cuBLAS's float32
# product adds in a fixed order.
ONEHOT_MAX_ROWS = 512


class _TableGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        return table[ids]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1)
        g = grad.reshape(flat.shape[0], -1).float()
        if ctx.rows <= ONEHOT_MAX_ROWS:
            onehot = (flat[:, None] == torch.arange(
                ctx.rows, device=flat.device)).float()
            out = torch.matmul(onehot.t(), g)
        else:
            out = torch.ops.aten.embedding_dense_backward(
                g, flat, ctx.rows, -1, False)
        return out.to(ctx.dtype), None


def table_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` whose backward sums the cotangent rows of each table
    row in float32, in a fixed order, and casts the sum to the table's dtype
    once: what the JAX package's ``table_gather`` transposes compute (a
    one-hot matmul or a sorted segment sum, both accumulating in float32).
    Autograd of ``table[ids]`` would accumulate a bf16 table's gradient in
    bf16. The embeddings and the factorized streams gather their tables
    through it; ``ids`` get no gradient."""
    return _TableGather.apply(table, ids)


ACTIVATIONS = {
    "gelu": F.gelu,  # exact (erf) gelu, the reference BERT's 'gelu'
    "relu": F.relu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
}
