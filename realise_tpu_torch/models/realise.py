"""The ReaLiSe model zoo as one ``nn.Module``.

The port of ``realise_tpu.models.realise.apply_realise`` (models/realise.py:
692-853) for every fine-tuning preset of ``config.MODEL_PRESETS`` and the
ablation switches (reference: src/models.py:32-1170, src/models_abla.py):

* semantic stream: a BERT over ``src_idx``;
* phonetic stream (``pho_encoder``): pho2, pinyin chars → masked GRU last
  hidden per token → pho BERT; pho1, the sum of three lookups of one
  65-symbol table (initial, final, tone) → pho BERT; or none;
* graphic stream (``res_encoder``): glyph gather → CharResNet (``resnet``)
  or CharResNet1 (``resnet1``) → ``resnet_layernorm``; or none;
* fusion: per-token gates over the 2 or 3 streams (``gate`` sigmoid,
  ``softmax_gate`` for arch4), ``concat`` (arch2: Linear over the
  concatenated streams, ``integrate``), ``sum``, ``merged`` (the
  SpellBertPho*[Res] presets: the raw glyph features, with no LayerNorm, are
  added to the pho stream's input embeddings before the pho BERT, and
  ``integrate`` reads [sem, pho], or [sem, res] without a pho stream), or
  ``baseline`` (the semantic stream alone);
* output block: a BERT of ``out_num_layers`` (0, 2 or 3) on the fused
  states with position ids forced to 0;
* head: a classifier tied to the word embeddings (only ``classifier.bias``
  is its own), or the untied MLM head (``cls.predictions``: dense → gelu →
  LayerNorm → decoder + bias; src/models.py:912). The logits are the hidden
  states times the table in the activation dtype plus the bias cast to it.

Parameter names are the reference's torch names (models/torch_import.py in
the JAX package maps them; the merged presets' ``pho_res_model`` is this
module's ``pho_model``), so :func:`realise_tpu_torch.models.convert.
state_dict_from_jax` carries JAX weights across and the JAX importer reads a
port state dict back. Serving swaps the per-token GRU and conv streams for
(V, H) tables that depend only on the token id
(:func:`precompute_inference_tables`). The pretraining stages
(``fusion="pretrain"``: ``pho2-pretrain``, ``res-pretrain``,
``pho2-res-pretrain``) are :class:`RealisePretrain`, on the same stream
modules; :func:`build_model` picks the class of a config.

A model starts in eval mode, the deterministic forward. In training mode
(``model.train()``) the forward is the training step's:
dropout on each stack's embedding output, inside every encoder layer and on
the fused hiddens before the head, all drawn from the caller's host
generator in the order semantic, pho, output block, head (a preset without
a stack draws nothing for it); BatchNorm on batch statistics (updating the
running ones); and ``loss_sum``/``loss_count`` of
:func:`masked_cross_entropy_sum`.

The GRU and conv streams depend only on the token id, so in either mode they
factorize over the vocabulary when that pays, as ``apply_realise`` routes
them (models/realise.py:747-775 of the JAX package), computing the same
function and gradients:

* the GRU (pho2 only) scans each distinct pinyin row once (the tables of
  :meth:`Realise.install_pho_vocab_tables`, ~1.3k rows against V = 21128)
  when the call has more token slots than rows, and tokens gather their row;
* the CharResNet (either variant, any fusion) runs over the distinct glyph
  rows (the dedup of :meth:`Realise.install_glyphs`: non-CJK tokens share
  the zero image) when the call has more token slots than rows, or over the
  call's own distinct rows when the batch carries them
  (``res_rows``/``res_inverse``/``res_counts``, counted on the host by
  :meth:`Realise.conv_rows`), with the BatchNorm statistics weighted by each
  row's occurrence count.

The per-token streams stay as the reference path (``per_token=True``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from realise_tpu_torch.config import (
    PHO1_VOCAB_SIZE,
    PHO2_VOCAB_SIZE,
    RealiseConfig,
)
from realise_tpu_torch.ops.bert import BertModel
from realise_tpu_torch.ops.fusion import concat_fusion, gate_fusion, sum_fusion
from realise_tpu_torch.ops.gru import gru_last_hidden, gru_last_hidden_factored
from realise_tpu_torch.ops.kernels import masked_ce as kce
from realise_tpu_torch.ops.layers import (
    ACTIVATIONS,
    dense,
    dropout,
    embed,
    layer_norm,
    random_key,
    table_gather,
)
from realise_tpu_torch.ops.resnet import CharResNet
from realise_tpu_torch.utils.profiler import no_span


class _MaskedCE(torch.autograd.Function):
    """(sum of NLL over masked positions, their count) in float32, with the
    JAX package's hand VJP (models/realise.py:599-678): the logits are
    ``round(logits + bias rounded to their dtype)`` (the logits as they are
    without a bias), the gradient of the logits is emitted in their dtype
    and the bias gradient is the float32 column sum of that rounded
    gradient. ``ops/kernels/masked_ce`` computes the rows: its kernels on
    CUDA, where the backward runs under ``span('head+ce.bwd')``, its plain
    versions on the CPU."""

    @staticmethod
    def forward(ctx, logits, bias, labels, mask, span):
        logz, gold = kce.masked_ce_fwd(logits, bias, labels)
        m = mask.float()
        ctx.span = span if logits.is_cuda else no_span
        ctx.save_for_backward(logits, bias, labels, m, logz)
        return ((logz - gold) * m).sum(), m.sum()

    @staticmethod
    def backward(ctx, dsum, _dcount):
        logits, bias, labels, m, logz = ctx.saved_tensors
        with ctx.span("head+ce.bwd"):
            dlogits, dbias = kce.masked_ce_bwd(logits, bias, labels, m, logz,
                                               dsum)
        return dlogits, dbias, None, None, None


def masked_cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor,
                             loss_mask: torch.Tensor,
                             bias: Optional[torch.Tensor] = None,
                             span=no_span):
    """(B, S, V) unbiased logits, (V,) float32 head bias (None: the logits
    are the biased ones) → (loss sum, count) over the positions where
    ``loss_mask`` is 1. ``span``: the hook whose 'head+ce.bwd' brackets the
    kernel backward."""
    v = logits.shape[-1]
    return _MaskedCE.apply(logits.reshape(-1, v), bias,
                           labels.reshape(-1).long(), loss_mask.reshape(-1),
                           span)


class TiedClassifier(nn.Module):
    """The classifier whose weight is the word-embedding table: it owns only
    its bias (``classifier.bias``)."""

    def __init__(self, vocab_size: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(vocab_size))


class _Transform(nn.Module):
    def __init__(self, cfg: RealiseConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class _Predictions(nn.Module):
    def __init__(self, cfg: RealiseConfig):
        super().__init__()
        self.transform = _Transform(cfg)
        self.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))


class MLMHead(nn.Module):
    """BertOnlyMLMHead (``cls.predictions.*``, reference:
    modeling_bert.py:436-462): dense → activation → LayerNorm → an untied
    decoder, and its own bias. :meth:`forward` returns the logits without
    the bias, and the bias, so that the training loss folds the bias in
    (``apply_head_split`` of the JAX package, models/realise.py:100-128)."""

    def __init__(self, cfg: RealiseConfig):
        super().__init__()
        self.cfg = cfg
        self.predictions = _Predictions(cfg)

    def forward(self, hidden: torch.Tensor):
        p, cfg = self.predictions, self.cfg
        t = p.transform
        h = ACTIVATIONS[cfg.hidden_act](dense(hidden, t.dense.weight,
                                              t.dense.bias))
        h = layer_norm(h, t.LayerNorm.weight, t.LayerNorm.bias,
                       cfg.layer_norm_eps)
        return torch.matmul(h, p.decoder.weight.to(h.dtype).t()), p.bias


def row_bucket(n: int) -> int:
    """``n`` rounded up to a multiple of 2^(bits(n) − 4): at most an eighth
    more rows, and eight row counts in each octave."""
    q = 1 << max(n.bit_length() - 4, 0)
    return -(-n // q) * q


def _check_wiring(cfg: RealiseConfig) -> None:
    if cfg.fusion == "pretrain":
        raise ValueError(
            f"{cfg.model_type!r} is a pretraining stage (fusion 'pretrain'): "
            f"RealisePretrain builds it (build_model picks the class by "
            f"config)")
    for what, value, known in (
            ("pho_encoder", cfg.pho_encoder, ("none", "pho1", "pho2")),
            ("res_encoder", cfg.res_encoder, ("none", "resnet", "resnet1")),
            ("fusion", cfg.fusion, ("baseline", "merged", "concat", "gate",
                                    "softmax_gate", "sum")),
            ("head", cfg.head, ("linear_tied", "mlm"))):
        if value not in known:
            raise ValueError(f"unknown {what} {value!r}; known: {known}")


class _TokenStreams(nn.Module):
    """What :class:`Realise` and :class:`RealisePretrain` share: the streams
    that depend only on the token id (the pho2 GRU or the pho1 lookups, the
    CharResNet of either variant), their factorized routes and dedup
    tables, the glyph tensor ``char_images_multifonts`` and the init.

    The factorized streams' tables are non-persistent buffers derived from
    the glyphs and the pinyin featurization, so ``state_dict()`` holds the
    reference's keys only: ``res_uniq_first`` (G,) / ``res_uniq_inverse``
    (V,), each distinct glyph's first vocab row and each vocab row's glyph,
    re-derived by :meth:`install_glyphs` and after every ``load_state_dict``
    (None when more than 0.75·V glyphs are distinct: the conv then runs over
    the V vocab rows); ``pho_uniq_idx`` (U, P) / ``pho_uniq_lens`` (U,) /
    ``pho_uniq_inverse`` (V,), set by :meth:`install_pho_vocab_tables`
    (pho2 only).

    ``span(name)`` brackets each part of the forward ('semantic', 'glyph',
    'gru' (the pho2 GRU or the pho1 lookups), 'pho_bert', 'fusion+output',
    'head+ce'); the encoder stacks hand it to their train kernels, whose
    backwards bracket 'encoder.attn_bwd' and 'encoder.ffn_bwd'; the Trainer
    adds the rest of the step (training/trainer.py). The default,
    :func:`no_span`, brackets nothing; a caller that times the parts sets
    its own context-manager factory (``utils/profiler.SpanRecorder``). Each
    site reads the hook when it runs, so it can be swapped at any step.

    ``tp``: the rank's ``MeshGroups`` once ``parallel/tensor.shard_module``
    split the model over a ``model`` axis (its dropout then indexes the
    global batch)."""

    tp = None

    def _finish_init(self, generator: Optional[torch.Generator]) -> None:
        """The glyph tensor, the derived tables' buffers and the seeded
        init (``generator``: a CPU ``torch.Generator``; default seed 0),
        after a subclass has built its parts."""
        cfg = self.cfg
        if cfg.with_res:
            self.register_buffer("char_images_multifonts", torch.zeros(
                cfg.vocab_size, cfg.num_fonts, cfg.glyph_size, cfg.glyph_size))
        for name in ("res_uniq_first", "res_uniq_inverse", "pho_uniq_idx",
                     "pho_uniq_lens", "pho_uniq_inverse"):
            self.register_buffer(name, None, persistent=False)
        self._res_inverse_host: Optional[np.ndarray] = None
        self.register_load_state_dict_post_hook(
            lambda module, _keys: module._derive_glyph_tables())
        self.span = no_span
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.init_weights(generator)
        self.eval()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's init: normal(0, initializer_range) for linear,
        embedding and GRU weights, He normal for convolutions, zero biases
        (the heads' too), unit LayerNorm/BatchNorm scales, fresh BN
        statistics."""
        std = self.cfg.initializer_range
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=generator)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.GRU):
                for pname, p in mod.named_parameters():
                    if pname.startswith("weight"):
                        p.normal_(0.0, std, generator=generator)
                    else:
                        p.zero_()
            elif isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, (2.0 / fan_in) ** 0.5,
                                   generator=generator)
            elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
                mod.reset_parameters()
            elif isinstance(mod, (TiedClassifier, _Predictions)):
                mod.bias.zero_()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @torch.no_grad()
    def install_glyphs(self, glyphs) -> None:
        """Copy a (V, num_fonts, 32, 32) glyph tensor into the model and
        derive its dedup tables. A model without a glyph stream has no glyph
        tensor and takes ``None``."""
        if not self.cfg.with_res:
            if glyphs is not None:
                raise ValueError(f"{self.cfg.model_type!r} without a glyph "
                                 f"stream takes no glyphs")
            return
        self.char_images_multifonts.copy_(torch.as_tensor(np.asarray(glyphs)))
        self._derive_glyph_tables()

    def _derive_glyph_tables(self) -> None:
        """Bitwise row dedup of the glyphs (``install_glyphs`` of the JAX
        package, without its padding to 128 rows, a TPU tiling rule)."""
        self.res_uniq_first = self.res_uniq_inverse = None
        self._res_inverse_host = None
        if not self.cfg.with_res:
            return
        glyphs = self.char_images_multifonts
        if glyphs.device.type == "meta":
            return
        v = glyphs.shape[0]
        flat = np.ascontiguousarray(
            glyphs.detach().reshape(v, -1).cpu().numpy())
        rows = flat.view(np.dtype((np.void, flat.itemsize * flat.shape[1])))
        _, first, inverse = np.unique(rows.ravel(), return_index=True,
                                      return_inverse=True)
        if first.shape[0] > 0.75 * v:
            return  # barely any sharing: convolve the vocab rows
        inverse = inverse.reshape(v).astype(np.int64)
        self.res_uniq_first = torch.as_tensor(first, device=glyphs.device)
        self.res_uniq_inverse = torch.as_tensor(inverse, device=glyphs.device)
        self._res_inverse_host = inverse

    @torch.no_grad()
    def install_pho_vocab_tables(self, idx, lens) -> None:
        """Install the distinct rows of the (V, P) pinyin ids + (V,) lengths
        of every vocab token (``Featurizer.pho2_tables``) and each token's
        row: the factorized GRU's tables (``install_pho_vocab_tables`` of
        the JAX package, without its padding to 128 rows). A no-op for a
        model without the pho2 GRU, as in the JAX package
        (``_install_constants``), and without tables (``idx`` None: the GRU
        then runs per token)."""
        if self.cfg.pho_encoder != "pho2" or idx is None:
            return
        idx, lens = np.asarray(idx, np.int64), np.asarray(lens, np.int64)
        rows = np.concatenate([idx, lens[:, None]], axis=1)
        uniq, inverse = np.unique(rows, axis=0, return_inverse=True)
        device = self.device
        self.pho_uniq_idx = torch.as_tensor(uniq[:, :-1], device=device)
        self.pho_uniq_lens = torch.as_tensor(uniq[:, -1], device=device)
        self.pho_uniq_inverse = torch.as_tensor(inverse.reshape(-1),
                                                device=device)

    @property
    def res_conv_rows(self) -> int:
        """Rows of the table the vocab-unique conv stream runs over."""
        if self.res_uniq_first is not None:
            return self.res_uniq_first.shape[0]
        return self.char_images_multifonts.shape[0]

    def conv_rows(self, src_idx, group=None) -> Dict[str, np.ndarray]:
        """The distinct conv-table rows of one forward call's (B, S) host
        ids: {'res_rows': (R,) sorted rows, 'res_inverse': (B, S) positions
        in them, 'res_counts': (R,) each row's occurrences}; {} for a model
        without a glyph stream. Counted with numpy before the batch goes to
        the device, so the forward needs no ``torch.unique`` (a host sync
        mid-step); training-mode BatchNorm weighs each row by its count.

        The U distinct rows are padded to R = :func:`row_bucket` (U) by
        repeating the last one; a pad counts 0 and no token points at it,
        so it weighs 0 in BatchNorm and gets no gradient. Every new row
        count is a new set of convolution shapes, for which cuDNN builds
        its execution plans on the host; with a count of its own for each
        batch that took more time than the convolutions (PERF.md §6), with
        the buckets the counts repeat from batch to batch.

        ``group``: a process group whose ranks each hold a part of one
        batch (the data ranks of a tensor-parallel step). The counts are
        then all-reduced over it, and the rows are those of the whole
        batch, the same on every rank, with this rank's tokens' positions
        in them: each rank runs the conv of one process over the whole
        batch, BatchNorm statistics included."""
        if not self.cfg.with_res:
            return {}
        ids = np.asarray(src_idx, np.int64)
        if self._res_inverse_host is not None:
            ids = self._res_inverse_host[ids]
        counts = np.bincount(ids.ravel(), minlength=self.res_conv_rows)
        if group is not None:
            total = torch.as_tensor(counts, device=self.device)
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
            counts = total.cpu().numpy()
        rows = np.nonzero(counts)[0]
        pad = row_bucket(rows.shape[0]) - rows.shape[0]
        return {"res_rows": np.pad(rows, (0, pad), mode="edge"),
                "res_inverse": np.searchsorted(rows, ids),
                "res_counts": np.pad(counts[rows], (0, pad))}

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    # ------------------------------------------------------------ streams
    def res_features(self, flat_ids: torch.Tensor,
                     use_kernels: bool = False) -> torch.Tensor:
        """(N,) token ids → (N, H) CharResNet features in the activation
        dtype; ``use_kernels``: the training-mode BatchNorm kernels."""
        images = self.char_images_multifonts[flat_ids].to(self.dtype)
        return self.resnet(images, use_kernels=use_kernels)

    def gru_features(self, pho_idx: torch.Tensor,
                     pho_lens: torch.Tensor) -> torch.Tensor:
        """(N, P) pinyin ids, (N,) lengths → (N, H) last valid GRU hidden."""
        g = self.pho_gru
        emb = embed(self.pho_embeddings.weight, pho_idx, self.dtype)
        return gru_last_hidden(g.weight_ih_l0, g.weight_hh_l0, g.bias_ih_l0,
                               g.bias_hh_l0, emb, pho_lens)

    def _factorized_gru(self, src_idx: torch.Tensor) -> torch.Tensor:
        """One scan over the distinct pinyin rows, gathered per token
        (``_factorized_gru`` of the JAX package): table_gather's transpose
        sums the tokens' cotangents into each row."""
        g = self.pho_gru
        table = gru_last_hidden_factored(
            g.weight_ih_l0, g.weight_hh_l0, g.bias_ih_l0, g.bias_hh_l0,
            self.pho_embeddings.weight.to(self.dtype), self.pho_uniq_idx,
            self.pho_uniq_lens)
        return table_gather(table, self.pho_uniq_inverse[src_idx])

    def _factorized_conv(self, src_idx: torch.Tensor,
                         rows: Optional[torch.Tensor] = None,
                         inverse: Optional[torch.Tensor] = None,
                         counts: Optional[torch.Tensor] = None,
                         use_kernels: bool = False) -> torch.Tensor:
        """The CharResNet over distinct glyph rows, gathered per token
        (``_factorized_conv`` of the JAX package): the call's own rows
        (:meth:`conv_rows`: ``rows`` (U,) of the conv table, each token's
        position ``inverse`` in them and each row's occurrence ``counts``)
        or, without them, every row of the table. In training mode
        BatchNorm weighs each row by its occurrence count, the statistics
        of the per-token batch (rows absent from the call count 0); over
        the whole table the counts are summed in the graph, and float32
        sums of ones are exact up to 2²⁴, so they are the same bits
        whatever order ``index_add_`` adds in. ``use_kernels``: the
        training-mode BatchNorm kernels."""
        weights = None
        if rows is None:
            inverse = (src_idx if self.res_uniq_inverse is None
                       else self.res_uniq_inverse[src_idx])
            first = self.res_uniq_first
            images = (self.char_images_multifonts if first is None
                      else self.char_images_multifonts[first])
            if self.training:
                flat = inverse.reshape(-1)
                weights = torch.zeros(images.shape[0],
                                      device=flat.device).index_add_(
                    0, flat, torch.ones(flat.shape, device=flat.device))
        else:
            first = (rows if self.res_uniq_first is None
                     else self.res_uniq_first[rows])
            images = self.char_images_multifonts[first]
            if self.training:
                weights = counts.float()
        feats = self.resnet(images.to(self.dtype), weights, use_kernels)
        return table_gather(feats, inverse)

    def _glyph_features(self, batch, tables, per_token,
                        use_kernels=False) -> torch.Tensor:
        """(B, S, H) raw CharResNet features of the batch's tokens: from the
        'res' table, the factorized conv or the per-token conv."""
        src_idx = batch["src_idx"]
        b, s = src_idx.shape
        rows = None if per_token else batch.get("res_rows")
        if "res" in tables:
            return tables["res"].to(self.dtype)[src_idx]
        if rows is not None or (not per_token and b * s > self.res_conv_rows):
            return self._factorized_conv(src_idx, rows,
                                         batch.get("res_inverse"),
                                         batch.get("res_counts"), use_kernels)
        return self.res_features(src_idx.reshape(-1),
                                 use_kernels).reshape(b, s, -1)

    def _pho_inputs(self, batch, tables, per_token) -> torch.Tensor:
        """(B, S, H) input embeddings of the pho BERT: the pho2 GRU's last
        hiddens (from the 'pho' table, the factorized scan or the per-token
        scan) or the sum of the three pho1 lookups (``_pho1_stream`` of the
        JAX package: one table, rounded to the activation dtype, summed)."""
        src_idx = batch["src_idx"]
        b, s = src_idx.shape
        if self.cfg.pho_encoder == "pho1":
            return embed(self.pho_embeddings.weight, batch["pho1_idx"],
                         self.dtype).sum(dim=2)
        if "pho" in tables:
            return tables["pho"].to(self.dtype)[src_idx]
        if (not per_token and self.pho_uniq_idx is not None
                and b * s > self.pho_uniq_idx.shape[0]):
            return self._factorized_gru(src_idx)
        gru_h = self.gru_features(batch["pho_idx"].reshape(b * s, -1),
                                  batch["pho_lens"].reshape(b * s))
        return gru_h.reshape(b, s, -1)


class Realise(_TokenStreams):
    """ReaLiSe of any fine-tuning preset. ``generator`` seeds the initial
    weights (a CPU ``torch.Generator``; default seed 0); a pretraining stage
    raises (:class:`RealisePretrain` builds those).

    A model has the parts its config wires (the module docstring), and its
    ``state_dict()`` the reference's keys of those parts alone: no
    ``char_images_multifonts`` without a glyph stream, no
    ``resnet_layernorm`` for the merged presets, ``integrate`` for merged
    and concat fusion, ``gate_net`` for the gates, ``cls.predictions`` for
    the MLM head."""

    def __init__(self, cfg: RealiseConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_wiring(cfg)
        self.cfg = cfg
        h = cfg.hidden_size
        self.bert = BertModel(cfg, cfg.num_hidden_layers)
        if cfg.with_pho:
            symbols = (PHO2_VOCAB_SIZE if cfg.pho_encoder == "pho2"
                       else PHO1_VOCAB_SIZE)
            self.pho_embeddings = nn.Embedding(symbols, h)
            if cfg.pho_encoder == "pho2":
                self.pho_gru = nn.GRU(h, h, batch_first=True)
            self.pho_model = BertModel(cfg, cfg.pho_num_layers, with_word=False)
        if cfg.with_res:
            self.resnet = CharResNet(cfg.num_fonts, h, cfg.res_encoder)
            if cfg.fusion != "merged":
                self.resnet_layernorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        n = cfg.num_streams
        if cfg.fusion in ("gate", "softmax_gate"):
            self.gate_net = nn.Linear((n + 1) * h, n)
        elif cfg.fusion in ("merged", "concat"):
            self.integrate = nn.Linear((2 if cfg.fusion == "merged" else n) * h, h)
        self.output_block = (BertModel(cfg, cfg.out_num_layers, with_word=False)
                             if cfg.out_num_layers > 0 else None)
        if cfg.head == "mlm":
            self.cls = MLMHead(cfg)
        else:
            self.classifier = TiedClassifier(cfg.vocab_size)
        self._finish_init(generator)

    def forward(self, batch: Dict[str, torch.Tensor],
                tables: Optional[Dict[str, torch.Tensor]] = None,
                use_kernels: bool = False,
                return_gates: bool = False,
                generator: Optional[torch.Generator] = None,
                per_token: bool = False) -> Dict[str, torch.Tensor]:
        """→ {'logits' (B, S, V), 'gates'?, 'loss_sum', 'loss_count'}.

        ``batch``: src_idx, masks (B, S); pho2: pho_idx (B, S, P) + pho_lens
        (B, S) unless ``tables`` holds the precomputed 'pho' table or the GRU
        factorizes; pho1: pho1_idx (B, S, 3); with tgt_idx and loss_masks
        (B, S) the loss sum and count come too, and in training mode they
        come instead of the logits (the loss reads the unbiased logits; the
        biased (B, S, V) tensor is not built); with res_rows (U,) and
        res_inverse (B, S) from :meth:`conv_rows` the conv stream runs over
        those rows. ``tables``: {'res', 'pho'} (V, H) from
        :func:`precompute_inference_tables` (eval mode only).
        ``use_kernels``: run every encoder layer through the fused block
        kernels (ops/kernels/bert_block.py in eval mode, bert_block_train.py
        in training mode) and, in training mode, the CharResNet's BatchNorms
        through ops/kernels/batch_norm.py. ``return_gates``: the (B, S, N)
        gates of a gate fusion. ``generator``: the host generator of the
        training mode's dropout keys and layer seeds. ``per_token``: run
        both streams per token slot, never factorized (the reference path,
        for comparison)."""
        cfg, dtype = self.cfg, self.dtype
        mask, src_idx = batch["masks"], batch["src_idx"]
        if self.training and tables:
            raise ValueError("the inference tables serve eval mode only; "
                             "training runs the live streams")
        tables = tables or {}
        span = self.span
        merged = cfg.fusion == "merged"

        with span("semantic"):
            sem = self.bert(input_ids=src_idx, attention_mask=mask,
                            use_kernels=use_kernels, generator=generator,
                            span=span)

        res = None
        if cfg.with_res:
            with span("glyph"):
                res = self._glyph_features(batch, tables, per_token,
                                           use_kernels)
                if not merged:
                    ln = self.resnet_layernorm
                    res = layer_norm(res, ln.weight, ln.bias,
                                     cfg.layer_norm_eps)

        streams = [sem]
        if cfg.with_pho:
            with span("gru"):
                pho_in = self._pho_inputs(batch, tables, per_token)
                if merged and res is not None:
                    # The merged presets' raw glyph features join the pho
                    # BERT's input (src/models.py:354-357, 485-489).
                    pho_in = pho_in + res
            with span("pho_bert"):
                streams.append(self.pho_model(
                    inputs_embeds=pho_in, attention_mask=mask,
                    use_kernels=use_kernels, generator=generator, span=span))
        if res is not None and not (merged and cfg.with_pho):
            streams.append(res)

        with span("fusion+output"):
            gates = None
            if cfg.fusion in ("gate", "softmax_gate"):
                hidden, gates = gate_fusion(
                    self.gate_net.weight, self.gate_net.bias, streams, mask,
                    softmax_gate=(cfg.fusion == "softmax_gate"),
                    return_gates=True)
            elif cfg.fusion in ("merged", "concat"):
                hidden = concat_fusion(self.integrate.weight,
                                       self.integrate.bias, streams)
            elif cfg.fusion == "sum":
                hidden = sum_fusion(streams)
            else:  # baseline
                hidden = sem
            if self.output_block is not None:
                position_ids = (torch.zeros_like(src_idx)
                                if cfg.zero_out_positions else None)
                hidden = self.output_block(inputs_embeds=hidden,
                                           attention_mask=mask,
                                           position_ids=position_ids,
                                           use_kernels=use_kernels,
                                           generator=generator, span=span)
            if self.training and generator is not None:
                hidden = dropout(hidden, cfg.hidden_dropout_prob,
                                 random_key(generator),
                                 None if self.tp is None
                                 else self.tp.rows(hidden))

        with span("head+ce"):
            if cfg.head == "mlm":
                logits_nb, bias = self.cls(hidden)
            else:
                word = self.bert.embeddings.word_embeddings.weight
                logits_nb = torch.matmul(hidden, word.to(dtype).t())
                bias = self.classifier.bias
            has_loss = "tgt_idx" in batch and "loss_masks" in batch
            out = {}
            if not (self.training and has_loss):
                out["logits"] = logits_nb + bias.to(dtype)
            if return_gates and gates is not None:
                out["gates"] = gates
            if has_loss:
                out["loss_sum"], out["loss_count"] = masked_cross_entropy_sum(
                    logits_nb, batch["tgt_idx"], batch["loss_masks"], bias,
                    span)
        return out


class RealisePretrain(_TokenStreams):
    """The pretraining stages of the reference (``init_pretrain`` and
    ``apply_pretrain`` of the JAX package, models/realise.py:962-1098;
    reference src/models.py:1174-1488), by preset:

    * ``pho2-pretrain`` (Pho2Pretrain): recover each char from its pinyin
      alone: the pho2 GRU's last hiddens → the pho BERT (``pho_model``) →
      the MLM head ``cls2.predictions``, the loss over ``loss_masks``
      (``Featurizer.featurize_pho_pretrain``: the inputs are the target ids,
      the loss covers Chinese chars);
    * ``res-pretrain`` (ResPretrain): classify a char from its glyph stack:
      ``char_idx`` (N,) → CharResNet → dropout → the linear head ``cls3``
      (its own bias, added to the logits rounded to the activation dtype);
      the labels are the char ids themselves, so the loss always comes;
    * ``pho2-res-pretrain`` (Pho2ResPretrain): the GRU hiddens plus the RAW
      CharResNet features (no LayerNorm) → the pho BERT, named
      ``pho_res_model`` as in the reference → ``cls2.predictions``.

    The MLM heads fold their bias into the float32 loss (``apply_head_split``
    of the JAX package), as :class:`Realise`'s does. The streams factorize
    as :class:`Realise` routes them (the GRU and the conv each on its own row
    count); ``res-pretrain`` convolves its (N,) chars as they come. Dropout
    (training mode) draws from the caller's generator: the glyph features'
    (``res-pretrain``) and the pho BERT's; no layer runs on the head's
    input. A state dict holds the reference's keys of the stage."""

    def __init__(self, cfg: RealiseConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        wiring = {"pho2-pretrain": ("pho2", False, "mlm"),
                  "res-pretrain": ("none", True, "linear"),
                  "pho2-res-pretrain": ("pho2", True, "mlm")}
        if cfg.fusion != "pretrain" or cfg.model_type not in wiring:
            raise ValueError(
                f"{cfg.model_type!r} (fusion {cfg.fusion!r}) is not a "
                f"pretraining stage; known: {sorted(wiring)} (Realise builds "
                f"the fine-tuning presets)")
        if (cfg.pho_encoder, cfg.with_res, cfg.head) != wiring[cfg.model_type]:
            raise ValueError(
                f"{cfg.model_type!r} wires pho_encoder, a glyph stream and "
                f"head as {wiring[cfg.model_type]}, got {cfg.pho_encoder!r}, "
                f"{cfg.with_res}, {cfg.head!r}")
        self.cfg = cfg
        h = cfg.hidden_size
        self._pho_bert_name = None
        if cfg.with_pho:
            self.pho_embeddings = nn.Embedding(PHO2_VOCAB_SIZE, h)
            self.pho_gru = nn.GRU(h, h, batch_first=True)
        if cfg.with_res:
            self.resnet = CharResNet(cfg.num_fonts, h, cfg.res_encoder)
        if cfg.with_pho:
            self._pho_bert_name = ("pho_res_model" if cfg.with_res
                                   else "pho_model")
            self.add_module(self._pho_bert_name, BertModel(
                cfg, cfg.pho_num_layers, with_word=False))
            self.cls2 = MLMHead(cfg)
        else:
            self.cls3 = nn.Linear(h, cfg.vocab_size)
        self._finish_init(generator)

    @property
    def pho_bert(self) -> Optional[BertModel]:
        """The pho BERT (``pho_model`` or ``pho_res_model``); None for
        ``res-pretrain``."""
        return (None if self._pho_bert_name is None
                else getattr(self, self._pho_bert_name))

    def forward(self, batch: Dict[str, torch.Tensor],
                use_kernels: bool = False,
                generator: Optional[torch.Generator] = None,
                per_token: bool = False) -> Dict[str, torch.Tensor]:
        """→ {'logits', 'loss_sum', 'loss_count'}; in training mode the
        logits do not come (the loss reads the unbiased ones).

        ``batch``: ``res-pretrain``: char_idx (N,) → logits (N, V) and the
        loss; the others: src_idx (the target ids), masks, pho_idx and
        pho_lens (B, S, P) unless the GRU factorizes, and res_rows /
        res_inverse of :meth:`conv_rows` for the glyph stream where the batch
        has them → logits (B, S, V), and the loss when tgt_idx and
        loss_masks come too. ``use_kernels``, ``generator`` and
        ``per_token`` as in :meth:`Realise.forward`."""
        if self.pho_bert is None:
            return self._classify_glyphs(batch["char_idx"], generator,
                                         use_kernels)
        cfg, span = self.cfg, self.span
        with span("gru"):
            hidden = self._pho_inputs(batch, {}, per_token)
        if cfg.with_res:
            with span("glyph"):
                hidden = hidden + self._glyph_features(batch, {}, per_token,
                                                       use_kernels)
        with span("pho_bert"):
            seq = self.pho_bert(inputs_embeds=hidden,
                                attention_mask=batch["masks"],
                                use_kernels=use_kernels, generator=generator,
                                span=span)
        with span("head+ce"):
            logits_nb, bias = self.cls2(seq)
            has_loss = "tgt_idx" in batch and "loss_masks" in batch
            out = {}
            if not (self.training and has_loss):
                out["logits"] = logits_nb + bias.to(logits_nb.dtype)
            if has_loss:
                out["loss_sum"], out["loss_count"] = masked_cross_entropy_sum(
                    logits_nb, batch["tgt_idx"], batch["loss_masks"], bias,
                    span)
        return out

    def _classify_glyphs(self, char_idx: torch.Tensor,
                         generator: Optional[torch.Generator],
                         use_kernels: bool = False
                         ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        with self.span("glyph"):
            feats = self.res_features(char_idx, use_kernels)
            if self.training and generator is not None:
                feats = dropout(feats, cfg.hidden_dropout_prob,
                                random_key(generator))
        with self.span("head+ce"):
            logits = dense(feats, self.cls3.weight, self.cls3.bias)
            out = {} if self.training else {"logits": logits}
            out["loss_sum"], out["loss_count"] = masked_cross_entropy_sum(
                logits[:, None], char_idx[:, None],
                torch.ones_like(char_idx[:, None]), span=self.span)
        return out


def build_model(cfg: RealiseConfig,
                generator: Optional[torch.Generator] = None) -> _TokenStreams:
    """The model of a config: :class:`RealisePretrain` for a pretraining
    stage (``fusion="pretrain"``), :class:`Realise` for every other preset."""
    cls = RealisePretrain if cfg.fusion == "pretrain" else Realise
    return cls(cfg, generator=generator)


@torch.no_grad()
def precompute_inference_tables(model: Realise, vocab_pho_idx=None,
                                vocab_pho_lens=None,
                                batch_size: int = 4096) -> Dict[str, torch.Tensor]:
    """Per-vocab-id glyph features and GRU hiddens, (V, H) each in the
    activation dtype, on the model's device.

    Both depend only on the token id, so at inference the conv stack and the
    GRU loop reduce to table gathers. The 'res' table holds the raw
    CharResNet features, before ``resnet_layernorm`` (the merged presets
    read them raw), for either variant; models without a glyph stream get
    none. ``vocab_pho_idx/lens``: (V, P)/(V,) pinyin featurization of every
    vocab token (``Featurizer.pho2_tables``); with them a pho2 model gets
    its 'pho' table. A pho1 model's lookups are already a table: it gets
    none, as in the JAX package (models/realise.py:878-960)."""
    tables = {}
    device = model.device
    if model.cfg.with_res:
        v = model.char_images_multifonts.shape[0]
        ids = torch.arange(v, device=device)
        tables["res"] = torch.cat([model.res_features(ids[i:i + batch_size])
                                   for i in range(0, v, batch_size)])
    if model.cfg.pho_encoder == "pho2" and vocab_pho_idx is not None:
        idx = torch.as_tensor(np.asarray(vocab_pho_idx), dtype=torch.long,
                              device=device)
        lens = torch.as_tensor(np.asarray(vocab_pho_lens), dtype=torch.long,
                               device=device)
        tables["pho"] = torch.cat([
            model.gru_features(idx[i:i + batch_size], lens[i:i + batch_size])
            for i in range(0, idx.shape[0], batch_size)])
    return tables
