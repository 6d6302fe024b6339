"""The head's masked cross-entropy on the CPU: the port's
``masked_cross_entropy_sum`` (the plain versions of
``ops/kernels/masked_ce``) against the JAX package's hand VJP, with and
without a folded bias, in float32 and bfloat16; the wrappers' CPU route;
the three callers (the fine-tuning head, the MLM head of pho2 pretraining,
res-pretrain's glyph classes) all through the one wrapper; and the
backward's row chunk as the kernel source has it. The kernels themselves
run in ``tests/test_torch_cuda.py``."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realise_tpu.models.realise import masked_cross_entropy_sum as jax_ce
from realise_tpu_torch.config import PHO2_VOCAB_SIZE, config_for
from realise_tpu_torch.models import realise as trealise
from realise_tpu_torch.ops.kernels import _build
from realise_tpu_torch.ops.kernels import masked_ce as kce

B, S, V = 3, 13, 67
DSUM = 1.7
# dlogits against the JAX VJP, in ulps of each element: the two logsumexps
# may differ in their last bit, and a change of logz (up to ~30 here, an
# ulp of 2e-6) moves every p = exp(l - logz) by that much relatively, up to
# 32 float32 ulps; in bf16 it moves a rounding by at most one.
ULPS = {"float32": 128.0, "bfloat16": 1.0}


def _inputs(dtype, with_bias, seed=0):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, S, V) * 3).astype(np.float32)
    logits[0, :4] *= 6
    labels = rng.randint(0, V, (B, S))
    labels[0, :2], labels[1, :2] = 0, V - 1
    mask = (rng.rand(B, S) > 0.3).astype(np.int64)
    mask[0, 0] = mask[1, 0] = 0
    bias = (rng.randn(V) * 0.5).astype(np.float32) if with_bias else None
    return logits, labels, mask, bias


def _ulps(got, want, dtype):
    """Largest |got - want| in ulps of the larger magnitude (bf16 2^-7 of
    it at most, float32 2^-23)."""
    eps = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -23
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(g - w)
    scale = np.maximum(np.abs(g), np.abs(w)) * eps
    return float(np.max(np.where(diff == 0, 0.0, diff / np.maximum(scale, 1e-38))))


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_masked_ce_matches_the_jax_vjp(dtype, with_bias):
    """Loss sum and count, dlogits (in the logits' dtype, within ``ULPS``)
    and dbias (float32 sums of those dlogits) under a cotangent of 1.7,
    including rows with mask 0 and labels at columns 0 and V-1."""
    logits, labels, mask, bias = _inputs(dtype, with_bias)
    x = torch.tensor(logits).to(getattr(torch, dtype)).requires_grad_(True)
    b = None if bias is None else torch.tensor(bias, requires_grad=True)
    loss, count = trealise.masked_cross_entropy_sum(
        x, torch.tensor(labels), torch.tensor(mask), b)
    (DSUM * loss).backward()

    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    if bias is None:
        (jloss, jcount), vjp = jax.vjp(
            lambda a: jax_ce(a, jnp.asarray(labels), jnp.asarray(mask)), jl)
        (jdl,) = vjp((jnp.float32(DSUM), jnp.float32(0)))
    else:
        (jloss, jcount), vjp = jax.vjp(
            lambda a, c: jax_ce(a, jnp.asarray(labels), jnp.asarray(mask),
                                bias=c), jl, jnp.asarray(bias))
        jdl, jdb = vjp((jnp.float32(DSUM), jnp.float32(0)))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    assert count.item() == float(jcount) == mask.sum()
    assert x.grad.dtype == x.dtype
    assert _ulps(x.grad.float().numpy(), np.asarray(jdl, np.float32),
                 dtype) <= ULPS[dtype]
    assert not x.grad.float().numpy()[mask == 0].any()
    if bias is not None:
        # A one-ulp flip of a label's entry (-1.7) moves its column's sum
        # by up to 2^-7 of it.
        atol = 2.0 ** -7 * DSUM if dtype == "bfloat16" else 1e-6
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(jdb),
                                   rtol=1e-5, atol=atol)


@pytest.mark.parametrize("with_bias", [True, False])
def test_wrappers_take_the_plain_versions_on_the_cpu(with_bias):
    """On CPU tensors the wrappers return the plain versions' bits and
    launch nothing."""
    logits, labels, mask, bias = _inputs("bfloat16", with_bias, seed=3)
    x = torch.tensor(logits).bfloat16().reshape(-1, V)
    lab = torch.tensor(labels).reshape(-1)
    m = torch.tensor(mask).reshape(-1).float()
    b = None if bias is None else torch.tensor(bias)
    dsum = torch.tensor(DSUM)
    launches = (kce.masked_ce_fwd.launches, kce.masked_ce_bwd.launches)
    got = kce.masked_ce_fwd(x, b, lab)
    want = kce.masked_ce_fwd_plain(x, b, lab)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = kce.masked_ce_bwd(x, b, lab, m, want[0], dsum)
    want = kce.masked_ce_bwd_plain(x, b, lab, m, want[0], dsum)
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) == (want[1] is None) == (bias is None)
    if bias is not None:
        assert torch.equal(got[1], want[1])
    assert (kce.masked_ce_fwd.launches, kce.masked_ce_bwd.launches) == launches


def _caller_batch(preset, cfg, rng):
    if preset == "res-pretrain":
        return {"char_idx": torch.as_tensor(rng.randint(0, V, (12,)))}
    b, s = 2, 9
    masks = np.ones((b, s), np.int64)
    masks[1, 6:] = 0
    batch = {"src_idx": rng.randint(0, V, (b, s)),
             "tgt_idx": rng.randint(0, V, (b, s)),
             "masks": masks, "loss_masks": masks.copy(),
             "pho_idx": rng.randint(1, PHO2_VOCAB_SIZE, (b, s, 8)),
             "pho_lens": rng.randint(0, 9, (b, s))}
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("preset,bias_name", [
    ("bert-pho2-res-arch3", "classifier.bias"),
    ("pho2-pretrain", "cls2.predictions.bias"),
    ("res-pretrain", None)])
def test_each_caller_goes_through_the_one_wrapper(monkeypatch, preset,
                                                  bias_name):
    """A training forward and backward of each caller calls
    ``masked_ce_fwd`` and ``masked_ce_bwd`` once each, with its own head's
    bias (none for res-pretrain, whose logits are biased already) and the
    logits of its head's width."""
    cfg = config_for(preset, vocab_size=V, hidden_size=16,
                     num_attention_heads=2, intermediate_size=32,
                     num_hidden_layers=1, pho_num_layers=1, out_num_layers=1,
                     max_seq_length=16, max_position_embeddings=16,
                     num_fonts=1)
    gen = torch.Generator().manual_seed(0)
    model = trealise.build_model(cfg, generator=gen)
    if cfg.with_pho:
        rng = np.random.RandomState(1)
        model.install_pho_vocab_tables(
            rng.randint(1, PHO2_VOCAB_SIZE, (V, 8)).astype(np.int32),
            rng.randint(0, 9, (V,)).astype(np.int32))
    model.train()
    calls = []
    for name in ("masked_ce_fwd", "masked_ce_bwd"):
        real = getattr(kce, name)

        def record(logits, bias, *rest, _real=real, _name=name):
            calls.append((_name, logits.shape[-1], bias))
            return _real(logits, bias, *rest)

        monkeypatch.setattr(kce, name, record)
    out = model(_caller_batch(preset, cfg, np.random.RandomState(2)),
                generator=torch.Generator().manual_seed(3))
    out["loss_sum"].backward()
    params = dict(model.named_parameters())
    want_bias = None if bias_name is None else params[bias_name]
    assert [(n, v) for n, v, _ in calls] == [("masked_ce_fwd", V),
                                             ("masked_ce_bwd", V)]
    for _, _, bias in calls:
        assert bias is want_bias
    if bias_name is not None:
        assert params[bias_name].grad is not None


def test_row_chunk_matches_the_kernel_source():
    """The wrapper sizes the backward's partials by the kernel's row
    chunk."""
    src = (_build.CSRC_DIR / "masked_ce.cu").read_text()
    assert int(re.search(r"kChunk = (\d+);", src).group(1)) == kce.ROW_CHUNK
