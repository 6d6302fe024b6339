"""BERT encoder as ``nn.Module``s with the reference's torch parameter names.

The module tree mirrors HuggingFace's BertModel (``embeddings.*``,
``encoder.layer.{i}.attention.self.query`` …), so a state dict carries the
names that ``realise_tpu/models/torch_import.py`` maps. The computation is
``realise_tpu.ops.bert`` with its mixed-precision rules (ops/layers.py):
post-LN layers, an additive −10000 padding bias, ``inputs_embeds`` and a
position-id override. Layers run as a ``ModuleList``. A layer runs the two
fused block kernels (ops/kernels/bert_block.py) when ``use_kernels`` is set,
else the plain sub-blocks :func:`_self_attention` / :func:`_ffn`. The port's
forward is always deterministic (dropout and the pooler are training-side).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.ops.kernels import bert_block
from realise_tpu_torch.ops.layers import ACTIVATIONS, dense, embed, layer_norm


def attention_bias_from_mask(attention_mask: torch.Tensor,
                             dtype: torch.dtype) -> torch.Tensor:
    """(B, S) {0,1} mask → (B, 1, 1, S) additive bias in ``dtype``."""
    bias = (1.0 - attention_mask.float()) * -10000.0
    return bias[:, None, None, :].to(dtype)


class BertEmbeddings(nn.Module):
    """``with_word=False`` for stacks only ever fed ``inputs_embeds``
    (the pho BERT and the output block)."""

    def __init__(self, cfg: RealiseConfig, with_word: bool = True):
        super().__init__()
        h = cfg.hidden_size
        if with_word:
            self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h)
        self.LayerNorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)


class BertSelfAttention(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)


class BertDenseLN(nn.Module):
    """``dense`` + ``LayerNorm`` (BertSelfOutput / BertOutput)."""

    def __init__(self, d_in: int, h: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, h)
        self.LayerNorm = nn.LayerNorm(h, eps=eps)


class BertAttention(nn.Module):
    def __init__(self, cfg: RealiseConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg.hidden_size)
        self.output = BertDenseLN(cfg.hidden_size, cfg.hidden_size,
                                  cfg.layer_norm_eps)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: RealiseConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)


def _self_attention(att: BertAttention, hidden: torch.Tensor,
                    attn_bias: torch.Tensor, cfg: RealiseConfig) -> torch.Tensor:
    b, s, h = hidden.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    sa = att.self
    q = dense(hidden, sa.query.weight, sa.query.bias).reshape(b, s, nh, hd)
    k = dense(hidden, sa.key.weight, sa.key.bias).reshape(b, s, nh, hd)
    v = dense(hidden, sa.value.weight, sa.value.bias).reshape(b, s, nh, hd)
    # (B, H, S, S) scores in float32 for a stable softmax.
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    probs = torch.softmax(scores + attn_bias.float(), dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(hidden.dtype).float(),
                       v.float()).to(hidden.dtype).reshape(b, s, h)
    out = dense(ctx, att.output.dense.weight, att.output.dense.bias)
    ln = att.output.LayerNorm
    return layer_norm(hidden + out, ln.weight, ln.bias, cfg.layer_norm_eps)


def _ffn(layer: "BertLayer", hidden: torch.Tensor,
         cfg: RealiseConfig) -> torch.Tensor:
    act = ACTIVATIONS[cfg.hidden_act]
    inter = act(dense(hidden, layer.intermediate.dense.weight,
                      layer.intermediate.dense.bias))
    out = dense(inter, layer.output.dense.weight, layer.output.dense.bias)
    ln = layer.output.LayerNorm
    return layer_norm(hidden + out, ln.weight, ln.bias, cfg.layer_norm_eps)


class BertLayer(nn.Module):
    def __init__(self, cfg: RealiseConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertDenseLN(cfg.intermediate_size, cfg.hidden_size,
                                  cfg.layer_norm_eps)
        self._packed: Optional[Tuple[tuple, Dict, Dict]] = None

    def kernel_params(self, dtype: torch.dtype) -> Tuple[Dict, Dict]:
        """The packed (attention, ffn) parameters of the block kernels in
        ``dtype``, kept until a parameter changes (dtype, device or an
        in-place write, which bumps the tensor's version)."""
        params = list(self.parameters())
        key = (dtype,) + tuple((p.data_ptr(), p._version) for p in params)
        if self._packed is None or self._packed[0] != key:
            att = self.attention
            self._packed = (
                key,
                bert_block.pack_attention_params(
                    att.self.query, att.self.key, att.self.value,
                    att.output.dense, att.output.LayerNorm, dtype),
                bert_block.pack_ffn_params(
                    self.intermediate.dense, self.output.dense,
                    self.output.LayerNorm, dtype))
        return self._packed[1], self._packed[2]

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor,
                use_kernels: bool = False) -> torch.Tensor:
        cfg = self.cfg
        if use_kernels:
            p_att, p_ffn = self.kernel_params(hidden.dtype)
            hidden = bert_block.attention_block(
                hidden, p_att, attn_bias, cfg.num_attention_heads,
                cfg.layer_norm_eps)
            return bert_block.ffn_block(hidden, p_ffn, cfg.layer_norm_eps)
        hidden = _self_attention(self.attention, hidden, attn_bias, cfg)
        return _ffn(self, hidden, cfg)


class BertEncoder(nn.Module):
    def __init__(self, cfg: RealiseConfig, num_layers: int):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(num_layers))


class BertModel(nn.Module):
    """Embeddings + encoder → (B, S, H) sequence output (no pooler)."""

    def __init__(self, cfg: RealiseConfig, num_layers: int,
                 with_word: bool = True):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, with_word=with_word)
        self.encoder = BertEncoder(cfg, num_layers)

    def embedding_output(self, input_ids: Optional[torch.Tensor] = None,
                         inputs_embeds: Optional[torch.Tensor] = None,
                         position_ids: Optional[torch.Tensor] = None,
                         token_type_ids: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """Word + position + type embedding sum → LayerNorm."""
        cfg, emb = self.cfg, self.embeddings
        dtype = getattr(torch, cfg.dtype)
        if inputs_embeds is None:
            if input_ids is None:
                raise ValueError("need input_ids or inputs_embeds")
            inputs_embeds = embed(emb.word_embeddings.weight, input_ids, dtype)
        else:
            inputs_embeds = inputs_embeds.to(dtype)
        batch, seq = inputs_embeds.shape[:2]
        device = inputs_embeds.device
        if position_ids is None:
            position_ids = torch.arange(seq, device=device)[None, :]
        pos = embed(emb.position_embeddings.weight, position_ids, dtype)
        if token_type_ids is None:
            token_type_ids = torch.zeros((batch, seq), dtype=torch.long,
                                         device=device)
        typ = embed(emb.token_type_embeddings.weight, token_type_ids, dtype)
        hidden = inputs_embeds + pos + typ
        return layer_norm(hidden, emb.LayerNorm.weight, emb.LayerNorm.bias,
                          cfg.layer_norm_eps)

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                use_kernels: bool = False) -> torch.Tensor:
        hidden = self.embedding_output(input_ids, inputs_embeds,
                                       position_ids, token_type_ids)
        if attention_mask is None:
            attention_mask = torch.ones(hidden.shape[:2], dtype=torch.long,
                                        device=hidden.device)
        attn_bias = attention_bias_from_mask(attention_mask, hidden.dtype)
        if use_kernels:
            # The kernels take the (B, S) bias in float32 (the dtype-rounded
            # values, as the Pallas kernel reads them): convert once per stack.
            attn_bias = attn_bias.reshape(hidden.shape[:2]).float()
        for layer in self.encoder.layer:
            hidden = layer(hidden, attn_bias, use_kernels=use_kernels)
        return hidden
