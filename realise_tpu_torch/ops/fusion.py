"""Selective-modality gate fusion (reference: src/models.py:689,840-850).

The port of ``realise_tpu.ops.fusion``'s gate path: per token, a gate network
reads concat(sem, pho, res, mean-pooled sem) → one logit per stream; each
stream is scaled by its sigmoid gate (arch3) or by a softmax over the gates
(arch4) and the gated streams are summed. The mean-pool respects the padding
mask and accumulates in float32.
"""

from __future__ import annotations

from typing import List

import torch


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
    (B, S, (N+1)·H) concat never exists, in the JAX order of additions."""
    sem = streams[0]
    pooled = masked_mean_pool(sem, attention_mask)[:, None, :].expand_as(sem)
    h = sem.shape[-1]
    logits = bias.to(sem.dtype)
    for i, piece in enumerate(streams + [pooled]):
        w_i = weight[:, i * h:(i + 1) * h].to(piece.dtype)
        logits = logits + torch.matmul(piece, w_i.t())
    if softmax_gate:
        gates = torch.softmax(logits.float(), dim=-1).to(sem.dtype)
    else:
        gates = torch.sigmoid(logits)
    fused = sum(gates[..., i:i + 1] * s for i, s in enumerate(streams))
    if return_gates:
        return fused, gates
    return fused
