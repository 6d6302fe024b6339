"""BERT encoder as ``nn.Module``s with the reference's torch parameter names.

The module tree mirrors HuggingFace's BertModel (``embeddings.*``,
``encoder.layer.{i}.attention.self.query`` …), so a state dict carries the
names that ``realise_tpu/models/torch_import.py`` maps. The computation is
``realise_tpu.ops.bert`` with its mixed-precision rules (ops/layers.py):
post-LN layers, an additive −10000 padding bias, ``inputs_embeds`` and a
position-id override. Layers run as a ``ModuleList``.

A layer in eval mode runs the two fused block kernels
(ops/kernels/bert_block.py) when ``use_kernels`` is set, else the plain
sub-blocks :func:`_self_attention` / :func:`_ffn`. In training mode it runs
the differentiable train blocks with in-kernel dropout
(ops/kernels/bert_block_train.py; their plain versions for CPU tensors) when
``use_kernels`` is set, with one seed per layer drawn on the host from the
caller's generator in [0, 2**31 - 1) for every dropout site of the layer,
and the caller's span hook (``span``, the model's ``Realise.span`` at
forward time), which brackets their backwards as 'encoder.attn_bwd' and
'encoder.ffn_bwd'; else the plain sub-blocks with the counter-hash
``dropout`` at the reference's sites (attention probabilities, attention
output, FFN output), one key per site. The embedding output is dropped in
training mode too. The pooler is not ported. ``BertLayer`` and
``BertModel`` start in eval mode, the deterministic forward; ``.train()``
turns the training forward on.

Tensor parallelism (``parallel/tensor.shard_module`` sets ``tp``, the
rank's ``MeshGroups``, on every stack and layer): a layer holds its rank's
column slices of q/k/v and of the FFN's first product and its row slices of
the attention output and of the FFN's second product, and runs the plain
sub-blocks in eval and in training mode, never the kernels, which need the
whole hidden dim (the JAX Trainer's rule, trainer.py:288-304). Its local
head count is read from the query weight's rows. :func:`copy_to_model`
goes before the column-parallel products; the row-parallel partial
products are float32, summed over the model group by
:func:`reduce_from_model` and rounded to the activation dtype once, and the
bias, the dropout, the residual and the LayerNorm follow on the full
hidden state (:func:`row_parallel_dense`). Every dropout site indexes its
mask by the element's place in the global array: the rows at the rank's
data offset, the attention probabilities at its head offset too
(``ops/layers.dropout``'s layout), so the masks are the one-process step's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.ops.kernels import bert_block, bert_block_train
from realise_tpu_torch.ops.layers import (
    ACTIVATIONS,
    dense,
    dropout,
    embed,
    layer_norm,
    random_key,
    stream_value,
)
from realise_tpu_torch.parallel.tensor import copy_to_model, reduce_from_model
from realise_tpu_torch.utils.profiler import no_span

KeyPair = Tuple[int, int]


def _generator_for(generator: Optional[torch.Generator], *rates: float):
    """The generator dropout draws from; raises when a rate needs one."""
    if generator is None and any(r > 0.0 for r in rates):
        raise ValueError("dropout in training mode needs a torch.Generator")
    return generator


def layer_seed(generator: Optional[torch.Generator]) -> int:
    """One int32 seed in [0, 2**31 - 1) (jax.random.randint's bounds in the
    JAX encoder), drawn on the host and moved to the generator's stream
    (``ops/layers.stream_value``: each data-parallel rank draws its own
    masks); 0 without a generator."""
    if generator is None:
        return 0
    modulus = 2 ** 31 - 1
    return stream_value(int(torch.randint(0, modulus, (1,),
                                          generator=generator)),
                        generator, modulus)


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


def row_parallel_dense(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, tp=None) -> torch.Tensor:
    """:func:`dense` of a row-parallel product: with ``tp`` the rank's
    partial product of its input columns in float32, summed over the model
    group, rounded to x's dtype once, then the (replicated) bias added once
    in that dtype; without, :func:`dense`."""
    if tp is None:
        return dense(x, weight, bias)
    partial = torch.matmul(x.float(), weight.float().t())
    return (reduce_from_model(partial, tp.model_group).to(x.dtype)
            + bias.to(x.dtype))


def _layout(tp, x: torch.Tensor, heads: bool = False):
    """The dropout layout of ``x`` on this rank (None without ``tp``)."""
    if tp is None:
        return None
    return tp.heads(x) if heads else tp.rows(x)


def _self_attention(att: BertAttention, hidden: torch.Tensor,
                    attn_bias: torch.Tensor, cfg: RealiseConfig,
                    keys: Optional[Tuple[KeyPair, KeyPair]] = None,
                    tp=None) -> torch.Tensor:
    """``keys``: dropout keys of the probabilities and of the output.
    ``tp``: the rank's ``MeshGroups`` of a sharded layer (its heads only)."""
    b, s, _ = hidden.shape
    hd = cfg.head_dim
    sa = att.self
    nh = sa.query.weight.shape[0] // hd  # this rank's heads
    x = hidden if tp is None else copy_to_model(hidden, tp.model_group)
    q = dense(x, sa.query.weight, sa.query.bias).reshape(b, s, nh, hd)
    k = dense(x, sa.key.weight, sa.key.bias).reshape(b, s, nh, hd)
    v = dense(x, sa.value.weight, sa.value.bias).reshape(b, s, nh, hd)
    # (B, H, S, S) scores in float32 for a stable softmax.
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    probs = torch.softmax(scores + attn_bias.float(), dim=-1)
    if keys is not None:
        probs = dropout(probs, cfg.attention_probs_dropout_prob, keys[0],
                        _layout(tp, probs, heads=True))
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(hidden.dtype).float(),
                       v.float()).to(hidden.dtype).reshape(b, s, nh * hd)
    out = row_parallel_dense(ctx, att.output.dense.weight,
                             att.output.dense.bias, tp)
    if keys is not None:
        out = dropout(out, cfg.hidden_dropout_prob, keys[1],
                      _layout(tp, out))
    ln = att.output.LayerNorm
    return layer_norm(hidden + out, ln.weight, ln.bias, cfg.layer_norm_eps)


def _ffn(layer: "BertLayer", hidden: torch.Tensor, cfg: RealiseConfig,
         key: Optional[KeyPair] = None, tp=None) -> torch.Tensor:
    act = ACTIVATIONS[cfg.hidden_act]
    x = hidden if tp is None else copy_to_model(hidden, tp.model_group)
    inter = act(dense(x, layer.intermediate.dense.weight,
                      layer.intermediate.dense.bias))
    out = row_parallel_dense(inter, layer.output.dense.weight,
                             layer.output.dense.bias, tp)
    if key is not None:
        out = dropout(out, cfg.hidden_dropout_prob, key, _layout(tp, out))
    ln = layer.output.LayerNorm
    return layer_norm(hidden + out, ln.weight, ln.bias, cfg.layer_norm_eps)


class BertLayer(nn.Module):
    tp = None  # the rank's MeshGroups once parallel/tensor.shard_module ran

    def __init__(self, cfg: RealiseConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertDenseLN(cfg.intermediate_size, cfg.hidden_size,
                                  cfg.layer_norm_eps)
        self._packed: Optional[Tuple[tuple, Dict, Dict]] = None
        self.eval()

    def kernel_params(self, dtype: torch.dtype) -> Tuple[Dict, Dict]:
        """The packed (attention, ffn) parameters of the block kernels in
        ``dtype`` (``bert_block.pack_attention`` / ``pack_ffn`` of
        :meth:`block_params`), kept until a parameter changes (dtype, device
        or an in-place write, which bumps the tensor's version; the CUDA
        update kernel bumps it too)."""
        params = list(self.parameters())
        key = (dtype,) + tuple((p.data_ptr(), p._version) for p in params)
        if self._packed is None or self._packed[0] != key:
            att, ffn = self.block_params()
            self._packed = (
                key,
                bert_block.pack_attention(
                    [att[k] for k in bert_block.ATTN_PARAMS], dtype),
                bert_block.pack_ffn(
                    [ffn[k] for k in bert_block.FFN_PARAMS], dtype))
        return self._packed[1], self._packed[2]

    def block_params(self) -> Tuple[Dict, Dict]:
        """The live parameters of the block kernels, by the names of
        ``bert_block.ATTN_PARAMS`` / ``FFN_PARAMS`` (no copy, no detach:
        the train blocks' gradients reach the modules)."""
        att, sa = self.attention, self.attention.self
        return ({"q_weight": sa.query.weight, "q_bias": sa.query.bias,
                 "k_weight": sa.key.weight, "k_bias": sa.key.bias,
                 "v_weight": sa.value.weight, "v_bias": sa.value.bias,
                 "out_weight": att.output.dense.weight,
                 "out_bias": att.output.dense.bias,
                 "ln_weight": att.output.LayerNorm.weight,
                 "ln_bias": att.output.LayerNorm.bias},
                {"w1": self.intermediate.dense.weight,
                 "b1": self.intermediate.dense.bias,
                 "w2": self.output.dense.weight,
                 "b2": self.output.dense.bias,
                 "ln_weight": self.output.LayerNorm.weight,
                 "ln_bias": self.output.LayerNorm.bias})

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor,
                use_kernels: bool = False,
                generator: Optional[torch.Generator] = None,
                span=no_span) -> torch.Tensor:
        cfg = self.cfg
        if self.tp is not None and use_kernels:
            raise ValueError("a tensor-parallel layer runs the plain "
                             "sub-blocks: the fused kernels need the whole "
                             "hidden dim")
        if self.training:
            return self._train_forward(hidden, attn_bias, use_kernels,
                                       generator, span)
        if use_kernels:
            p_att, p_ffn = self.kernel_params(hidden.dtype)
            hidden = bert_block.attention_block(
                hidden, p_att, attn_bias, cfg.num_attention_heads,
                cfg.layer_norm_eps)
            return bert_block.ffn_block(hidden, p_ffn, cfg.layer_norm_eps)
        hidden = _self_attention(self.attention, hidden, attn_bias, cfg,
                                 tp=self.tp)
        return _ffn(self, hidden, cfg, tp=self.tp)

    def _train_forward(self, hidden, attn_bias, use_kernels, generator,
                       span):
        cfg = self.cfg
        p_rate = cfg.attention_probs_dropout_prob
        h_rate = cfg.hidden_dropout_prob
        if use_kernels:
            seed = layer_seed(generator)
            p_att, p_ffn = self.block_params()
            hidden = bert_block_train.attention_block_train(
                hidden, p_att, attn_bias, seed, cfg.num_attention_heads,
                cfg.layer_norm_eps, p_rate, h_rate, span=span)
            return bert_block_train.ffn_block_train(
                hidden, p_ffn, seed, cfg.layer_norm_eps, h_rate, span=span)
        gen = _generator_for(generator, p_rate, h_rate)
        keys = (None if gen is None else
                (random_key(gen), random_key(gen), random_key(gen)))
        hidden = _self_attention(self.attention, hidden, attn_bias, cfg,
                                 keys and keys[:2], self.tp)
        return _ffn(self, hidden, cfg, keys and keys[2], self.tp)


class BertEncoder(nn.Module):
    def __init__(self, cfg: RealiseConfig, num_layers: int):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(num_layers))


class BertModel(nn.Module):
    """Embeddings + encoder → (B, S, H) sequence output (no pooler)."""

    tp = None  # the rank's MeshGroups once parallel/tensor.shard_module ran

    def __init__(self, cfg: RealiseConfig, num_layers: int,
                 with_word: bool = True):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, with_word=with_word)
        self.encoder = BertEncoder(cfg, num_layers)
        self.eval()

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
                use_kernels: bool = False,
                generator: Optional[torch.Generator] = None,
                span=no_span) -> torch.Tensor:
        """``generator`` (training mode): the host generator every dropout
        key and layer seed of this stack is drawn from. ``span``: the span
        hook each layer hands its train kernels."""
        cfg = self.cfg
        hidden = self.embedding_output(input_ids, inputs_embeds,
                                       position_ids, token_type_ids)
        if self.training:
            gen = _generator_for(generator, cfg.hidden_dropout_prob,
                                 cfg.attention_probs_dropout_prob)
            if gen is not None:
                hidden = dropout(hidden, cfg.hidden_dropout_prob,
                                 random_key(gen), _layout(self.tp, hidden))
        if attention_mask is None:
            attention_mask = torch.ones(hidden.shape[:2], dtype=torch.long,
                                        device=hidden.device)
        attn_bias = attention_bias_from_mask(attention_mask, hidden.dtype)
        if use_kernels:
            # The kernels take the (B, S) bias in float32 (the dtype-rounded
            # values, as the Pallas kernel reads them): convert once per stack.
            attn_bias = attn_bias.reshape(hidden.shape[:2]).float()
        for layer in self.encoder.layer:
            hidden = layer(hidden, attn_bias, use_kernels=use_kernels,
                           generator=generator, span=span)
        return hidden
