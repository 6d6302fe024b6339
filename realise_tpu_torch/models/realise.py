"""The ReaLiSe arch3 model (``bert-pho2-res-arch3``) as an ``nn.Module``.

The port of ``realise_tpu.models.realise.apply_realise`` (models/realise.py:
692-853) for the published wiring (reference: src/models.py:652-870):

* semantic stream: a BERT over ``src_idx``;
* phonetic stream: pinyin chars → masked GRU last hidden per token → pho BERT;
* graphic stream: glyph gather → CharResNet → ``resnet_layernorm``;
* fusion: per-token gates over the three streams (sigmoid; softmax for arch4);
* output block: a BERT on the fused states with position ids forced to 0;
* head: a classifier tied to the word embeddings (only ``classifier.bias`` is
  its own), ``hidden @ word_embeddings.T`` in the activation dtype plus the
  bias cast to it.

Parameter names are the reference's torch names (models/torch_import.py in
the JAX package maps them), so :func:`realise_tpu_torch.models.convert.
state_dict_from_jax` carries JAX weights across and the JAX importer reads a
port state dict back. Serving swaps the per-token GRU and conv streams for
(V, H) tables that depend only on the token id
(:func:`precompute_inference_tables`).

A model starts in eval mode, the deterministic forward. In training mode
(``model.train()``) the forward is the training step's:
dropout on each stack's embedding output, inside every encoder layer and on
the fused hiddens before the head, all drawn from the caller's host
generator; BatchNorm on batch statistics (updating the running ones); and
``loss_sum``/``loss_count`` of :func:`masked_cross_entropy_sum`. The streams
run per token; the vocabulary-factorized training streams and the other
presets of the zoo are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from realise_tpu_torch.config import PHO2_VOCAB_SIZE, RealiseConfig
from realise_tpu_torch.ops.bert import BertModel
from realise_tpu_torch.ops.fusion import gate_fusion
from realise_tpu_torch.ops.gru import gru_last_hidden
from realise_tpu_torch.ops.layers import dropout, embed, layer_norm, random_key
from realise_tpu_torch.ops.resnet import CharResNet


class _MaskedCE(torch.autograd.Function):
    """(sum of NLL over masked positions, their count) in float32, with the
    JAX package's hand VJP (models/realise.py:599-678): the logits are
    ``round(logits + bias rounded to their dtype)``, the gradient of the
    logits is emitted in their dtype and the bias gradient is the float32
    column sum of that rounded gradient."""

    @staticmethod
    def forward(ctx, logits, bias, labels, mask):
        l32 = _biased32(logits, bias)
        logz = torch.logsumexp(l32, dim=-1)
        gold = l32.gather(-1, labels[:, None])[:, 0]
        m = mask.float()
        ctx.save_for_backward(logits, bias, labels, m, logz)
        return ((logz - gold) * m).sum(), m.sum()

    @staticmethod
    def backward(ctx, dsum, _dcount):
        logits, bias, labels, m, logz = ctx.saved_tensors
        p = torch.exp(_biased32(logits, bias) - logz[:, None])
        p[torch.arange(p.shape[0], device=p.device), labels] -= 1.0
        dlogits = (p * (dsum * m)[:, None]).to(logits.dtype)
        return dlogits, dlogits.float().sum(0), None, None


def _biased32(logits: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    b32 = bias.to(logits.dtype).float()
    return (logits.float() + b32).to(logits.dtype).float()


def masked_cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor,
                             loss_mask: torch.Tensor, bias: torch.Tensor):
    """(B, S, V) unbiased logits, (V,) float32 head bias → (loss sum, count)
    over the positions where ``loss_mask`` is 1."""
    v = logits.shape[-1]
    return _MaskedCE.apply(logits.reshape(-1, v), bias,
                           labels.reshape(-1).long(), loss_mask.reshape(-1))


class TiedClassifier(nn.Module):
    """The classifier whose weight is the word-embedding table: it owns only
    its bias (``classifier.bias``)."""

    def __init__(self, vocab_size: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(vocab_size))


def unported_reason(cfg: RealiseConfig) -> Optional[str]:
    """Why the port cannot build this config yet (None = it can)."""
    if (cfg.pho_encoder, cfg.res_encoder, cfg.head) != ("pho2", "resnet",
                                                        "linear_tied"):
        return (f"only the pho2 + resnet + tied-head wiring is ported, got "
                f"{cfg.pho_encoder!r}/{cfg.res_encoder!r}/{cfg.head!r}")
    if cfg.fusion not in ("gate", "softmax_gate"):
        return f"fusion {cfg.fusion!r} is not ported yet"
    return None


class Realise(nn.Module):
    """arch3/arch4 ReaLiSe. ``generator`` seeds the initial weights (a CPU
    ``torch.Generator``; default seed 0)."""

    def __init__(self, cfg: RealiseConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        reason = unported_reason(cfg)
        if reason is not None:
            raise NotImplementedError(reason)
        self.cfg = cfg
        h = cfg.hidden_size
        self.bert = BertModel(cfg, cfg.num_hidden_layers)
        self.pho_embeddings = nn.Embedding(PHO2_VOCAB_SIZE, h)
        self.pho_gru = nn.GRU(h, h, batch_first=True)
        self.pho_model = BertModel(cfg, cfg.pho_num_layers, with_word=False)
        self.resnet = CharResNet(cfg.num_fonts, h, cfg.res_encoder)
        self.resnet_layernorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.gate_net = nn.Linear((cfg.num_streams + 1) * h, cfg.num_streams)
        self.output_block = (BertModel(cfg, cfg.out_num_layers, with_word=False)
                             if cfg.out_num_layers > 0 else None)
        self.classifier = TiedClassifier(cfg.vocab_size)
        self.register_buffer("char_images_multifonts", torch.zeros(
            cfg.vocab_size, cfg.num_fonts, cfg.glyph_size, cfg.glyph_size))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.init_weights(generator)
        self.eval()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's init: normal(0, initializer_range) for linear,
        embedding and GRU weights, He normal for convolutions, zero biases,
        unit LayerNorm/BatchNorm scales, fresh BN statistics."""
        std = self.cfg.initializer_range
        for name, mod in self.named_modules():
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
        self.classifier.bias.zero_()

    @torch.no_grad()
    def install_glyphs(self, glyphs) -> None:
        """Copy a (V, num_fonts, 32, 32) glyph tensor into the model."""
        self.char_images_multifonts.copy_(torch.as_tensor(np.asarray(glyphs)))

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    # ------------------------------------------------------------ streams
    def res_features(self, flat_ids: torch.Tensor) -> torch.Tensor:
        """(N,) token ids → (N, H) CharResNet features in the activation dtype."""
        images = self.char_images_multifonts[flat_ids].to(self.dtype)
        return self.resnet(images)

    def gru_features(self, pho_idx: torch.Tensor,
                     pho_lens: torch.Tensor) -> torch.Tensor:
        """(N, P) pinyin ids, (N,) lengths → (N, H) last valid GRU hidden."""
        g = self.pho_gru
        emb = embed(self.pho_embeddings.weight, pho_idx, self.dtype)
        return gru_last_hidden(g.weight_ih_l0, g.weight_hh_l0, g.bias_ih_l0,
                               g.bias_hh_l0, emb, pho_lens)

    def forward(self, batch: Dict[str, torch.Tensor],
                tables: Optional[Dict[str, torch.Tensor]] = None,
                use_kernels: bool = False,
                return_gates: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """→ {'logits' (B, S, V), 'gates'?, 'loss_sum', 'loss_count'}.

        ``batch``: src_idx, masks (B, S), and pho_idx (B, S, P) + pho_lens
        (B, S) unless ``tables`` holds the precomputed 'pho' table; with
        tgt_idx and loss_masks (B, S) the loss sum and count come too, and
        in training mode they come instead of the logits (the loss reads the
        unbiased logits; the biased (B, S, V) tensor is not built).
        ``tables``: {'res', 'pho'} (V, H) from :func:`precompute_inference_tables`
        (eval mode only). ``use_kernels``: run every encoder layer through the
        fused block kernels (ops/kernels/bert_block.py in eval mode,
        bert_block_train.py in training mode). ``generator``: the host
        generator of the training mode's dropout keys and layer seeds."""
        cfg, dtype = self.cfg, self.dtype
        mask, src_idx = batch["masks"], batch["src_idx"]
        b, s = src_idx.shape
        if self.training and tables:
            raise ValueError("the inference tables serve eval mode only; "
                             "training runs the per-token streams")
        tables = tables or {}

        sem = self.bert(input_ids=src_idx, attention_mask=mask,
                        use_kernels=use_kernels, generator=generator)

        if "res" in tables:
            feats = tables["res"].to(dtype)[src_idx]
        else:
            feats = self.res_features(src_idx.reshape(-1)).reshape(b, s, -1)
        ln = self.resnet_layernorm
        res = layer_norm(feats, ln.weight, ln.bias, cfg.layer_norm_eps)

        if "pho" in tables:
            gru_h = tables["pho"].to(dtype)[src_idx]
        else:
            gru_h = self.gru_features(batch["pho_idx"].reshape(b * s, -1),
                                      batch["pho_lens"].reshape(b * s))
            gru_h = gru_h.reshape(b, s, -1)
        pho = self.pho_model(inputs_embeds=gru_h, attention_mask=mask,
                             use_kernels=use_kernels, generator=generator)

        hidden, gates = gate_fusion(
            self.gate_net.weight, self.gate_net.bias, [sem, pho, res], mask,
            softmax_gate=(cfg.fusion == "softmax_gate"), return_gates=True)
        if self.output_block is not None:
            position_ids = (torch.zeros_like(src_idx)
                            if cfg.zero_out_positions else None)
            hidden = self.output_block(inputs_embeds=hidden,
                                       attention_mask=mask,
                                       position_ids=position_ids,
                                       use_kernels=use_kernels,
                                       generator=generator)
        if self.training and generator is not None:
            hidden = dropout(hidden, cfg.hidden_dropout_prob,
                             random_key(generator))

        word = self.bert.embeddings.word_embeddings.weight
        bias = self.classifier.bias
        logits_nb = torch.matmul(hidden, word.to(dtype).t())
        has_loss = "tgt_idx" in batch and "loss_masks" in batch
        out = {}
        if not (self.training and has_loss):
            out["logits"] = logits_nb + bias.to(dtype)
        if return_gates:
            out["gates"] = gates
        if has_loss:
            out["loss_sum"], out["loss_count"] = masked_cross_entropy_sum(
                logits_nb, batch["tgt_idx"], batch["loss_masks"], bias)
        return out


@torch.no_grad()
def precompute_inference_tables(model: Realise, vocab_pho_idx=None,
                                vocab_pho_lens=None,
                                batch_size: int = 4096) -> Dict[str, torch.Tensor]:
    """Per-vocab-id glyph features and GRU hiddens, (V, H) each in the
    activation dtype, on the model's device.

    Both depend only on the token id, so at inference the conv stack and the
    GRU loop reduce to table gathers. ``vocab_pho_idx/lens``: (V, P)/(V,)
    pinyin featurization of every vocab token (``Featurizer.pho2_tables``);
    without them only the 'res' table is built."""
    device = model.char_images_multifonts.device
    v = model.char_images_multifonts.shape[0]
    ids = torch.arange(v, device=device)
    tables = {"res": torch.cat([model.res_features(ids[i:i + batch_size])
                                for i in range(0, v, batch_size)])}
    if vocab_pho_idx is not None:
        idx = torch.as_tensor(np.asarray(vocab_pho_idx), dtype=torch.long,
                              device=device)
        lens = torch.as_tensor(np.asarray(vocab_pho_lens), dtype=torch.long,
                               device=device)
        tables["pho"] = torch.cat([
            model.gru_features(idx[i:i + batch_size], lens[i:i + batch_size])
            for i in range(0, idx.shape[0], batch_size)])
    return tables
