"""Masked GRU over the pinyin-character axis.

The port of ``realise_tpu.ops.gru.gru_last_hidden`` and
``gru_last_hidden_factored`` (the factorized stream's scan, the input
projection folded through the pinyin alphabet): a loop over a fixed pinyin
axis with per-step length masking,

    h_t = t < len ? GRUCell(h_{t-1}, x_t) : h_{t-1}

which keeps the last *valid* hidden state per sequence (the reference's
``pack_padded_sequence`` semantics, src/models.py:661-669). A length of 0
returns the zero state, which pad and special tokens need; that is why this
is not ``pack_padded_sequence``, which rejects length 0. Gate math is torch's
GRU cell: r/z/n order, ``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))``.
"""

from __future__ import annotations

import torch

from realise_tpu_torch.ops.layers import table_gather


def gru_last_hidden(weight_ih: torch.Tensor, weight_hh: torch.Tensor,
                    bias_ih: torch.Tensor, bias_hh: torch.Tensor,
                    inputs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """inputs: (N, P, D) padded sequences in the activation dtype; lengths:
    (N,) valid step counts; weights in torch's (3H, D) / (3H, H) layout.
    Returns (N, H) in the inputs' dtype."""
    n, p, _ = inputs.shape
    dtype = inputs.dtype
    # The input projections of every step in one matmul.
    gi_all = (torch.matmul(inputs.reshape(n * p, -1), weight_ih.to(dtype).t())
              + bias_ih.to(dtype)).reshape(n, p, -1)
    return _scan(gi_all, weight_hh, bias_hh, lengths)


def gru_last_hidden_factored(weight_ih: torch.Tensor, weight_hh: torch.Tensor,
                             bias_ih: torch.Tensor, bias_hh: torch.Tensor,
                             emb_table: torch.Tensor, idx: torch.Tensor,
                             lengths: torch.Tensor) -> torch.Tensor:
    """``gru_last_hidden`` of ``emb_table[idx]`` with the input projection
    folded through the embedding alphabet (the port of
    ``realise_tpu.ops.gru.gru_last_hidden_factored``).

    emb_table: (A, D) in the activation dtype (A = 33 pinyin symbols); idx:
    (N, P) symbol ids; lengths: (N,). ``tw = emb_table·W_ihᵀ + b_ih`` is
    computed once, (A, 3H), and each step's input projection is its rows
    ``tw[idx_t]``: a row pick gives the bits of JAX's one-hot matmul, whose
    one nonzero term is the row itself. All steps are picked by one
    :func:`table_gather`, so ``tw``'s gradient sums every step's rows in
    float32. Returns (N, H)."""
    dtype = emb_table.dtype
    tw = torch.matmul(emb_table, weight_ih.to(dtype).t()) + bias_ih.to(dtype)
    return _scan(table_gather(tw, idx), weight_hh, bias_hh, lengths)


def _scan(gi_all: torch.Tensor, weight_hh: torch.Tensor,
          bias_hh: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The masked recurrence over (N, P, 3H) input projections."""
    n, p, _ = gi_all.shape
    dtype = gi_all.dtype
    w_hh = weight_hh.to(dtype).t()
    b_hh = bias_hh.to(dtype)
    h = gi_all.new_zeros((n, weight_hh.shape[1]))
    for t in range(p):
        gh = torch.matmul(h, w_hh) + b_hh
        i_r, i_z, i_n = gi_all[:, t].chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        cand = torch.tanh(i_n + r * h_n)
        h_new = (1.0 - z) * cand + z * h
        h = torch.where((t < lengths)[:, None], h_new, h)
    return h
