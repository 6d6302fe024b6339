"""The training step's dropout masks, worked out from the trainer's seed.

The program draws every dropout key and layer seed of a step on the host
from one ``torch.Generator`` seeded with the trainer's seed (the benchmark
gives it that seed), in this order: the semantic stack's embedding key and
one seed per layer, the pho stack's, the output block's, then the key of
the fused hiddens before the head. :class:`Draws` draws the same values
from a generator of the same seed.

Masks are the counter hash the port documents (murmur3 fmix32 of a stream id
XOR the mixed element index), written here from that description:

* an embedding or head site, key words (k0, k1): element ``i`` of the flat
  (B, S, H) tensor is kept when the top 24 bits of
  ``mix(base ^ mix(i))`` fall under ``keep * 2^24``,
  ``base = mix(k1 ^ mix(k0 ^ 0x9E3779B1))``;
* a site inside an encoder layer of seed ``s``: one stream per example
  (attention output: site 2, FFN output: site 3) or per example and head
  (the probabilities: site 1), ``mix(s*0x9E3779B1 + site*0x85EBCA6B +
  example*0xC2B2AE35 + head*0x27D4EB2F)`` (mod 2^32); row-major element
  index ``i`` of the (S, cols) block; when ``cols % 256 == 0`` one hash
  gives two 16-bit samples (column ``c < cols/2`` from the low half of the
  hash of ``row*cols/2 + c``, the rest from the high half), else one 24-bit
  sample.

Kept values are scaled by 1 / keep.
"""

from __future__ import annotations

from typing import Tuple

import torch

M32 = 0xFFFFFFFF


def mul32(h, c: int):
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & M32


def mix32(h):
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def flat_mask(shape, key: Tuple[int, int], rate: float, device) -> torch.Tensor:
    """Float32 multiplier in {0, 1/keep} of an embedding or head site."""
    keep = 1.0 - rate
    k0, k1 = (int(k) & M32 for k in key)
    base = mix32(k1 ^ mix32(k0 ^ 0x9E3779B1))
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=device)
    bits = mix32(base ^ mix32(idx))
    kept = (bits >> 8) < min(int(keep * (1 << 24)), 1 << 24)
    return (kept.float() / keep).reshape(shape)


def _stream(seed: int, site: int, example: torch.Tensor, head) -> torch.Tensor:
    s = mul32(int(seed) & M32, 0x9E3779B1)
    s = (s + mul32(site, 0x85EBCA6B)) & M32
    s = (s + mul32(example, 0xC2B2AE35)) & M32
    s = (s + mul32(head, 0x27D4EB2F)) & M32
    return mix32(s)


def _block(base: torch.Tensor, rows: int, cols: int, keep: float) -> torch.Tensor:
    device = base.device
    if cols % 256 == 0:
        half = cols // 2
        idx = (torch.arange(rows, device=device)[:, None] * half
               + torch.arange(half, device=device)[None, :])
        bits = mix32(base ^ mix32(idx))
        t = min(int(keep * (1 << 16)), 1 << 16)
        kept = torch.cat([(bits & 0xFFFF) < t, (bits >> 16) < t], -1)
    else:
        idx = (torch.arange(rows, device=device)[:, None] * cols
               + torch.arange(cols, device=device)[None, :])
        bits = mix32(base ^ mix32(idx))
        kept = (bits >> 8) < min(int(keep * (1 << 24)), 1 << 24)
    return kept.float() / keep


SITE_PROBS, SITE_ATTN_OUT, SITE_FFN_OUT = 1, 2, 3


def hidden_mask(seed: int, site: int, b: int, s: int, h: int, rate: float,
                device) -> torch.Tensor:
    """(B, S, H) multiplier of a layer's attention-output or FFN-output site."""
    ex = torch.arange(b, dtype=torch.int64, device=device)
    return _block(_stream(seed, site, ex, 0)[:, None, None], s, h, 1.0 - rate)


def probs_mask(seed: int, b: int, heads: int, s: int, rate: float,
               device) -> torch.Tensor:
    """(B, heads, S, S) multiplier of a layer's attention probabilities."""
    ex = torch.arange(b, dtype=torch.int64, device=device)[:, None]
    hd = torch.arange(heads, dtype=torch.int64, device=device)[None, :]
    return _block(_stream(seed, SITE_PROBS, ex, hd)[..., None, None], s, s,
                  1.0 - rate)


class Draws:
    """The host draws of the program's trainer generator, in its order. A
    data-parallel rank ``stream`` > 0 draws the same values moved to its
    stream, ``(value + mix(stream) + stream * 0x9E3779B1) mod m`` (the first
    key word with m = 2^32, a layer seed with m = 2^31 - 1)."""

    def __init__(self, seed: int, stream: int = 0):
        self.gen = torch.Generator()
        self.gen.manual_seed(seed)
        self.stream = stream

    def _move(self, value: int, modulus: int) -> int:
        if not self.stream:
            return value
        return (value + mix32(self.stream) + self.stream * 0x9E3779B1) % modulus

    def key(self) -> Tuple[int, int]:
        w = torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                          generator=self.gen)
        return self._move(int(w[0]), 1 << 32), int(w[1])

    def layer_seed(self) -> int:
        modulus = 2 ** 31 - 1
        return self._move(int(torch.randint(0, modulus, (1,),
                                            generator=self.gen)), modulus)
