"""Stream fusion (the port of ``realise_tpu.ops.fusion``).

* :func:`gate_fusion` (reference: src/models.py:689,840-850): per token, a
  gate network reads concat(streams..., mean-pooled sem) → one logit per
  stream; each stream is scaled by its sigmoid gate (arch3) or by a softmax
  over the gates (arch4) and the gated streams are summed. N = 3 streams, or
  2 in the ablations without a pho or a res stream. The mean-pool respects
  the padding mask and accumulates in float32.
* :func:`concat_fusion`: Linear(concat(streams)) — the merged presets'
  ``integrate`` over two streams (src/models.py:228-233) and arch2's over
  three (src/models.py:513-649).
* :func:`sum_fusion`: the plain sum of the streams (the ``--fusion sum``
  ablation, src/models_abla.py:246-279).
"""

from __future__ import annotations

from typing import List

import torch

from realise_tpu_torch.ops.layers import dense


def masked_mean_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, S, H), (B, S) → (B, H): mean over valid positions, f32 accumulate."""
    m = mask.float()[..., None]
    total = (hidden.float() * m).sum(dim=1)
    count = m.sum(dim=1)
    return (total / torch.clamp(count, min=1.0)).to(hidden.dtype)


def gate_fusion(weight: torch.Tensor, bias: torch.Tensor,
                streams: List[torch.Tensor], attention_mask: torch.Tensor,
                softmax_gate: bool = False, return_gates: bool = False):
    """Fuse N streams with per-token gates conditioned on all streams and the
    mean-pooled semantic stream (streams[0]). ``weight``: the gate_net's
    torch (N, (N+1)·H) weight, applied one H-wide slice per piece so the
    (B, S, (N+1)·H) concat never exists, in the JAX order of additions.

    Each piece's N gate logits are a float32 product-sum over H rounded once
    to the piece's dtype (the JAX matmul with ``preferred_element_type``),
    taken as an elementwise product and a row reduction rather than a
    matmul: cuBLAS splits the K = H sum of an N = 3 product in a way that
    depends on the row count, so a row's gates (and a served sentence's
    corrections) changed with the rows beside it. The reduction's order
    depends on H alone."""
    sem = streams[0]
    pooled = masked_mean_pool(sem, attention_mask)[:, None, :].expand_as(sem)
    h = sem.shape[-1]
    logits = bias.to(sem.dtype)
    for i, piece in enumerate(streams + [pooled]):
        w_i = weight[:, i * h:(i + 1) * h].to(piece.dtype).float()
        product = (piece.float()[..., None, :] * w_i).sum(-1)
        logits = logits + product.to(piece.dtype)
    if softmax_gate:
        gates = torch.softmax(logits.float(), dim=-1).to(sem.dtype)
    else:
        gates = torch.sigmoid(logits)
    fused = sum(gates[..., i:i + 1] * s for i, s in enumerate(streams))
    if return_gates:
        return fused, gates
    return fused


def concat_fusion(weight: torch.Tensor, bias: torch.Tensor,
                  streams: List[torch.Tensor]) -> torch.Tensor:
    """``dense(concat(streams))``: one product over K = N·H, rounded once to
    the activation dtype, plus the bias (``weight``: torch's (H, N·H))."""
    return dense(torch.cat(streams, dim=-1), weight, bias)


def sum_fusion(streams: List[torch.Tensor]) -> torch.Tensor:
    """The streams added in order, in the activation dtype."""
    out = streams[0]
    for s in streams[1:]:
        out = out + s
    return out
