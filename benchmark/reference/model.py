"""The plain forward pass of a ReaLiSe preset, float32, over a flat dict of
weights named as the reference's torch state dict (src/models.py:652-870 for
arch3, :32-73 for the SpellBert baseline).

* semantic BERT (post-LN layers, additive -10000 padding bias, exact gelu);
* pho2 stream: each token's tone-first pinyin ids -> ``pho_embeddings`` ->
  a GRU that keeps the last valid hidden (length 0 keeps the zero state) ->
  the pho BERT, fed as input embeddings;
* glyph stream: each token's (fonts, 32, 32) glyph stack -> CharResNet
  (stride-2 BasicBlocks, conv-BN-ReLU-conv-BN plus a 1x1 conv-BN shortcut)
  -> ``resnet_layernorm``. Training-mode BatchNorm takes the statistics of
  the batch's B*S token slots, padding included, written here over the
  batch's distinct tokens weighted by their counts (the same sums);
* gate fusion: per-token sigmoid (or softmax) gates from [sem, pho, res,
  the masked mean of sem], a weighted sum of the streams;
* output block: a BERT over the fused states with position ids 0;
* dropout (training) on each stack's embedding output, inside every layer
  and on the fused states before the head, masks from :mod:`dropout`;
* head: the hidden states times the word-embedding table plus the
  classifier bias; the loss is the summed cross entropy over ``loss_masks``
  and its count.

``precision="fp8"`` is the control: every product (dense layers, attention,
GRU, convolutions, gate, head) takes its two operands rounded to float8
e4m3 with one scale per tensor (its largest magnitude to 448), the step a
later change could take below bfloat16; the rest stays float32. Gradients
pass the rounding unchanged.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import dropout as D

FP8_MAX = 448.0


def quantize_fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().max().clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach()


class Reference:
    """``cfg``: the configuration file's dict; ``weights``: name -> float32
    tensor on one device (buffers included: the glyphs, BN statistics);
    ``pho_ids``/``pho_lens``: (V, P)/(V,) pinyin ids of every token."""

    def __init__(self, cfg: Dict, weights: Dict[str, torch.Tensor],
                 pho_ids=None, pho_lens=None, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg = cfg
        self.P = weights
        self.fp8 = precision == "fp8"
        self.device = next(iter(weights.values())).device
        if pho_ids is not None:
            self.pho_ids = torch.as_tensor(pho_ids, device=self.device)
            self.pho_lens = torch.as_tensor(pho_lens, device=self.device)

    # ------------------------------------------------------------ pieces
    def q(self, x: torch.Tensor) -> torch.Tensor:
        return quantize_fp8(x) if self.fp8 else x

    def dense(self, x, name: str, bias: bool = True):
        y = torch.matmul(self.q(x), self.q(self.P[name + ".weight"]).t())
        return y + self.P[name + ".bias"] if bias else y

    def ln(self, x, name: str, eps: Optional[float] = None):
        eps = self.cfg["layer_norm_eps"] if eps is None else eps
        return F.layer_norm(x, x.shape[-1:], self.P[name + ".weight"],
                            self.P[name + ".bias"], eps)

    def layer(self, p: str, x, bias, seed: Optional[int]):
        cfg = self.cfg
        b, s, h = x.shape
        nh = cfg["num_attention_heads"]
        d = h // nh

        def heads(t):
            return t.reshape(b, s, nh, d).transpose(1, 2)

        q = heads(self.dense(x, p + "attention.self.query"))
        k = heads(self.dense(x, p + "attention.self.key"))
        v = heads(self.dense(x, p + "attention.self.value"))
        scores = torch.matmul(self.q(q), self.q(k).transpose(-1, -2))
        probs = torch.softmax(scores / math.sqrt(d) + bias, dim=-1)
        if seed is not None:
            probs = probs * D.probs_mask(
                seed, b, nh, s, cfg["attention_probs_dropout_prob"], x.device)
        ctx = torch.matmul(self.q(probs), self.q(v)).transpose(1, 2)
        out = self.dense(ctx.reshape(b, s, h), p + "attention.output.dense")
        rate = cfg["hidden_dropout_prob"]
        if seed is not None:
            out = out * D.hidden_mask(seed, D.SITE_ATTN_OUT, b, s, h, rate,
                                      x.device)
        x = self.ln(x + out, p + "attention.output.LayerNorm")
        inter = F.gelu(self.dense(x, p + "intermediate.dense"))
        out = self.dense(inter, p + "output.dense")
        if seed is not None:
            out = out * D.hidden_mask(seed, D.SITE_FFN_OUT, b, s, h, rate,
                                      x.device)
        return self.ln(x + out, p + "output.LayerNorm")

    def stack(self, prefix: str, layers: int, mask, draws, ids=None,
              embeds=None, zero_positions: bool = False):
        P = self.P
        e = prefix + "embeddings."
        x = P[e + "word_embeddings.weight"][ids] if ids is not None else embeds
        s = mask.shape[1]
        pos = (P[e + "position_embeddings.weight"][:1] if zero_positions
               else P[e + "position_embeddings.weight"][:s])
        x = x + pos + P[e + "token_type_embeddings.weight"][0]
        x = self.ln(x, e + "LayerNorm")
        if draws is not None:
            x = x * D.flat_mask(x.shape, draws.key(),
                                self.cfg["hidden_dropout_prob"], x.device)
        bias = (1.0 - mask.float())[:, None, None, :] * -10000.0
        for i in range(layers):
            seed = draws.layer_seed() if draws is not None else None
            name = f"{prefix}encoder.layer.{i}."
            if torch.is_grad_enabled() and x.requires_grad:
                # Keeps a layer's input alone for the backward, which runs
                # the layer again (its masks come from the seed): the
                # training step at B=256, S=128 fits beside nothing else.
                x = checkpoint(self.layer, name, x, bias, seed,
                               use_reentrant=False)
            else:
                x = self.layer(name, x, bias, seed)
        return x

    def gru(self, tokens):
        """(U,) token ids -> (U, H) last valid GRU hidden of their pinyin."""
        P = self.P
        idx, lens = self.pho_ids[tokens], self.pho_lens[tokens]
        x = P["pho_embeddings.weight"][idx]
        gi = (torch.matmul(self.q(x), self.q(P["pho_gru.weight_ih_l0"]).t())
              + P["pho_gru.bias_ih_l0"])
        w_hh = self.q(P["pho_gru.weight_hh_l0"]).t()
        h = x.new_zeros((x.shape[0], w_hh.shape[0]))
        for t in range(idx.shape[1]):
            gh = torch.matmul(self.q(h), w_hh) + P["pho_gru.bias_hh_l0"]
            i_r, i_z, i_n = gi[:, t].chunk(3, -1)
            h_r, h_z, h_n = gh.chunk(3, -1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            new = (1.0 - z) * torch.tanh(i_n + r * h_n) + z * h
            h = torch.where((t < lens)[:, None], new, h)
        return h

    def batch_norm(self, x, name: str, weights: Optional[torch.Tensor]):
        P, eps = self.P, 1e-5
        if weights is None:  # eval: the running statistics
            mean, var = P[name + ".running_mean"], P[name + ".running_var"]
        else:
            w = weights.float()[:, None, None, None]
            total = w.sum() * x.shape[2] * x.shape[3]
            mean = (x * w).sum(dim=(0, 2, 3)) / total
            var = (((x - mean[:, None, None]) ** 2) * w).sum(
                dim=(0, 2, 3)) / total
        y = (x - mean[:, None, None]) * torch.rsqrt(var + eps)[:, None, None]
        return y * P[name + ".weight"][:, None, None] + P[name + ".bias"][
            :, None, None]

    def conv(self, x, name: str, stride: int, padding: int):
        return F.conv2d(self.q(x), self.q(self.P[name + ".weight"]),
                        stride=stride, padding=padding)

    def resnet(self, images, weights: Optional[torch.Tensor]):
        x, k = images, 1
        while f"resnet.res_block{k}.residual_function.0.weight" in self.P:
            p = f"resnet.res_block{k}."
            h = torch.relu(self.batch_norm(
                self.conv(x, p + "residual_function.0", 2, 1),
                p + "residual_function.1", weights))
            h = self.batch_norm(self.conv(h, p + "residual_function.3", 1, 1),
                                p + "residual_function.4", weights)
            sc = self.batch_norm(self.conv(x, p + "shortcut.0", 2, 0),
                                 p + "shortcut.1", weights)
            x = torch.relu(h + sc)
            k += 1
        return x.reshape(x.shape[0], -1)

    # ------------------------------------------------------------ model
    def forward(self, src_idx, masks, train: bool = False,
                draws: Optional[D.Draws] = None, tgt_idx=None,
                loss_masks=None):
        """Eval: (B, S, V) logits. Training (``draws`` given): (loss sum,
        count) over ``loss_masks``."""
        cfg, P = self.cfg, self.P
        if train and draws is None:
            raise ValueError("the training forward needs the dropout draws")
        sem = self.stack("bert.", cfg["num_hidden_layers"], masks, draws,
                         ids=src_idx)
        streams = [sem]
        tokens, inverse, counts = torch.unique(
            src_idx, return_inverse=True, return_counts=True)
        if cfg["pho_encoder"] == "pho2":
            pho_in = self.gru(tokens)[inverse]
            streams.append(self.stack("pho_model.", cfg["pho_num_layers"],
                                      masks, draws, embeds=pho_in))
        elif cfg["pho_encoder"] != "none":
            raise ValueError(f"pho_encoder {cfg['pho_encoder']!r}")
        if cfg["res_encoder"] == "resnet":
            images = P["char_images_multifonts"][tokens]
            feats = self.resnet(images, counts if train else None)[inverse]
            streams.append(self.ln(feats, "resnet_layernorm"))
        elif cfg["res_encoder"] != "none":
            raise ValueError(f"res_encoder {cfg['res_encoder']!r}")
        if cfg["fusion"] in ("gate", "softmax_gate"):
            m = masks.float()[..., None]
            pooled = (sem * m).sum(1) / m.sum(1).clamp(min=1.0)
            pieces = streams + [pooled[:, None, :].expand_as(sem)]
            w, h = P["gate_net.weight"], sem.shape[-1]
            logits = P["gate_net.bias"]
            for i, piece in enumerate(pieces):
                logits = logits + torch.matmul(
                    self.q(piece), self.q(w[:, i * h:(i + 1) * h]).t())
            gates = (torch.softmax(logits, -1) if cfg["fusion"] == "softmax_gate"
                     else torch.sigmoid(logits))
            hidden = sum(gates[..., i:i + 1] * st
                         for i, st in enumerate(streams))
        elif cfg["fusion"] == "baseline":
            hidden = sem
        else:
            raise ValueError(f"fusion {cfg['fusion']!r}")
        if cfg["out_num_layers"]:
            hidden = self.stack("output_block.", cfg["out_num_layers"], masks,
                                draws, embeds=hidden,
                                zero_positions=cfg["zero_out_positions"])
        if draws is not None:
            hidden = hidden * D.flat_mask(hidden.shape, draws.key(),
                                          cfg["hidden_dropout_prob"],
                                          hidden.device)
        word = P["bert.embeddings.word_embeddings.weight"]
        if not train:
            return (torch.matmul(self.q(hidden), self.q(word).t())
                    + P["classifier.bias"])
        keep = loss_masks.bool()
        rows = hidden[keep]
        logits = (torch.matmul(self.q(rows), self.q(word).t())
                  + P["classifier.bias"])
        gold = tgt_idx[keep]
        nll = torch.logsumexp(logits, -1) - logits.gather(
            -1, gold[:, None])[:, 0]
        return nll.sum(), keep.sum().float()
