"""The port's fused block kernels (realise_tpu_torch/ops/kernels/bert_block.py)
against the JAX package's Pallas kernels (interpret mode) and jnp sub-blocks.

Inputs are made with numpy from a seed and fed to both packages. On the CPU
the wrappers run their plain versions; the CUDA kernels themselves are
checked against those plain versions on the card by tests/test_torch_cuda.py
and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realise_tpu.config import config_for
from realise_tpu.ops.bert import _ffn, _self_attention, attention_bias_from_mask
from realise_tpu.ops.pallas.bert_block import attention_block, ffn_block
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.models.convert import bert_state_dict
from realise_tpu_torch.ops import bert as tbert
from realise_tpu_torch.ops.kernels import bert_block as tbb
from realise_tpu_torch.ops.kernels import kernels_unviable_reason

F32_TOL = 2e-5
# bf16: both sides round every matmul output to bf16; a one-ulp flip of an
# intermediate can move an output by a bf16 ulp, so allow two ulps of |y|.
BF16_REL = 2.0 ** -6

CFG = config_for("bert-pho2-res-arch3", vocab_size=64, hidden_size=16,
                 num_hidden_layers=1, num_attention_heads=2,
                 intermediate_size=32, max_seq_length=8)
PCFG = RealiseConfig.from_dict(CFG.to_dict())
B, S = 3, 8


def _layer_params(seed=0):
    """One JAX BERT layer (unstacked) with every leaf random, incl. biases
    and LayerNorm, as numpy."""
    rng = np.random.RandomState(seed)
    h, i = CFG.hidden_size, CFG.intermediate_size

    def dense(n_in, n_out):
        return {"kernel": rng.normal(0, 0.3, (n_in, n_out)).astype(np.float32),
                "bias": rng.normal(0, 0.1, (n_out,)).astype(np.float32)}

    def ln(n):
        return {"scale": (1 + rng.normal(0, 0.1, (n,))).astype(np.float32),
                "bias": rng.normal(0, 0.1, (n,)).astype(np.float32)}

    return {"attention": {"query": dense(h, h), "key": dense(h, h),
                          "value": dense(h, h), "output": dense(h, h),
                          "layer_norm": ln(h)},
            "ffn": {"intermediate": dense(h, i), "output": dense(i, h),
                    "layer_norm": ln(h)}}


def _port_layer(jlayer):
    """The same weights in a port BertLayer."""
    stacked = {"embeddings": {
        "position_embeddings": {"embedding": np.zeros(
            (CFG.max_position_embeddings, 16), np.float32)},
        "token_type_embeddings": {"embedding": np.zeros((2, 16), np.float32)},
        "layer_norm": {"scale": np.ones(16, np.float32),
                       "bias": np.zeros(16, np.float32)}},
        "encoder": {sub: {name: {k: v[None] for k, v in leaf.items()}
                          for name, leaf in jlayer[sub].items()}
                    for sub in ("attention", "ffn")}}
    model = tbert.BertModel(PCFG, 1, with_word=False)
    model.load_state_dict(bert_state_dict(stacked, 1))
    return model.encoder.layer[0]


def _inputs(seed=1, dtype=np.float32):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (B, S, CFG.hidden_size)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, 5:] = 0
    mask[2, 2:] = 0
    return x, mask


def _to_t(x, dtype):
    return torch.tensor(x).to(dtype)


@pytest.fixture(scope="module")
def layers():
    jl = _layer_params()
    return jl, _port_layer(jl)


def _jax_attention(jl, x, mask, dtype):
    bias = attention_bias_from_mask(jnp.asarray(mask), dtype)
    return np.asarray(attention_block(
        jnp.asarray(x, dtype), jl["attention"], bias, CFG.num_attention_heads,
        eps=CFG.layer_norm_eps, interpret=True).astype(jnp.float32))


def _port_attention(pl, x, mask, dtype, fn=tbb.attention_block_plain):
    p, _ = pl.kernel_params(dtype)
    bias = tbert.attention_bias_from_mask(torch.tensor(mask), dtype)
    return fn(_to_t(x, dtype), p, bias, PCFG.num_attention_heads,
              PCFG.layer_norm_eps).float().numpy()


def _jax_ffn(jl, x, dtype):
    return np.asarray(ffn_block(jnp.asarray(x, dtype), jl["ffn"],
                                eps=CFG.layer_norm_eps, n_splits=1,
                                interpret=True).astype(jnp.float32))


def _port_ffn(pl, x, dtype, fn=tbb.ffn_block_plain):
    _, p = pl.kernel_params(dtype)
    return fn(_to_t(x, dtype), p, PCFG.layer_norm_eps).float().numpy()


def _assert_bf16_close(got, want):
    np.testing.assert_array_less(np.abs(got - want),
                                 BF16_REL * np.maximum(1.0, np.abs(want)) + 1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_block_plain_matches_pallas(layers, dtype):
    jl, pl = layers
    x, mask = _inputs()
    want = _jax_attention(jl, x, mask, getattr(jnp, dtype))
    got = _port_attention(pl, x, mask, getattr(torch, dtype))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL)
    else:
        _assert_bf16_close(got, want)
    # Garbage in masked positions must not change valid outputs.
    x2 = x.copy()
    x2[mask == 0] = 99.0
    got2 = _port_attention(pl, x2, mask, getattr(torch, dtype))
    valid = mask.astype(bool)
    np.testing.assert_allclose(got2[valid], got[valid], atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_block_plain_matches_pallas(layers, dtype):
    jl, pl = layers
    x, mask = _inputs(seed=2)
    want = _jax_ffn(jl, x, getattr(jnp, dtype))
    got = _port_ffn(pl, x, getattr(torch, dtype))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL)
    else:
        _assert_bf16_close(got, want)
    x2 = x.copy()
    x2[mask == 0] = 99.0
    valid = mask.astype(bool)
    np.testing.assert_array_equal(
        _port_ffn(pl, x2, getattr(torch, dtype))[valid], got[valid])


def test_plain_subblocks_match_jnp(layers):
    """The port's plain sub-blocks (ops/bert.py) == the JAX jnp sub-blocks,
    and the plain kernel versions == them up to the documented numerics
    differences (W2 rounding, scale multiply), invisible in f32."""
    jl, pl = layers
    x, mask = _inputs(seed=3)
    bias = attention_bias_from_mask(jnp.asarray(mask), jnp.float32)
    want_att = np.asarray(_self_attention(jl["attention"], jnp.asarray(x), bias,
                                          CFG, True, None))
    tbias = tbert.attention_bias_from_mask(torch.tensor(mask), torch.float32)
    with torch.no_grad():
        got_att = tbert._self_attention(pl.attention, torch.tensor(x), tbias,
                                        PCFG).numpy()
        got_ffn = tbert._ffn(pl, torch.tensor(x), PCFG).numpy()
    np.testing.assert_allclose(got_att, want_att, atol=F32_TOL)
    np.testing.assert_allclose(_port_attention(pl, x, mask, torch.float32),
                               want_att, atol=F32_TOL)

    want_ffn = np.asarray(_ffn(jl["ffn"], jnp.asarray(x), CFG, True, None))
    np.testing.assert_allclose(got_ffn, want_ffn, atol=F32_TOL)
    np.testing.assert_allclose(_port_ffn(pl, x, torch.float32), want_ffn,
                               atol=F32_TOL)


def test_cpu_wrappers_route_to_plain(layers):
    """For CPU tensors the wrappers ARE the plain versions and never count a
    kernel launch."""
    _, pl = layers
    x, mask = _inputs(seed=4)
    before = (tbb.attention_block.launches, tbb.ffn_block.launches)
    np.testing.assert_array_equal(
        _port_attention(pl, x, mask, torch.float32, fn=tbb.attention_block),
        _port_attention(pl, x, mask, torch.float32))
    np.testing.assert_array_equal(
        _port_ffn(pl, x, torch.float32, fn=tbb.ffn_block),
        _port_ffn(pl, x, torch.float32))
    assert (tbb.attention_block.launches, tbb.ffn_block.launches) == before


def test_kernel_params_cache_follows_weights(layers):
    """The packed kernel parameters are rebuilt after an in-place write."""
    _, pl = layers
    p1, _ = pl.kernel_params(torch.float32)
    assert pl.kernel_params(torch.float32)[0] is p1
    layer = _port_layer(_layer_params())
    before = layer.kernel_params(torch.float32)[0]["qkv_bias"].clone()
    with torch.no_grad():
        layer.attention.self.key.bias.add_(1.0)
    after = layer.kernel_params(torch.float32)[0]["qkv_bias"]
    h = PCFG.hidden_size
    np.testing.assert_allclose(after[h:2 * h].numpy(),
                               before[h:2 * h].numpy() + 1.0)
    assert layer.kernel_params(torch.bfloat16)[0]["qkv_weight"].dtype == \
        torch.bfloat16


@pytest.mark.parametrize("change, needle", [
    ({"hidden_act": "relu"}, "gelu"),
    ({"hidden_size": 256, "num_attention_heads": 2}, "head_dim"),
    ({"max_seq_length": 256}, "max_seq_length"),
])
def test_kernels_unviable_reason(change, needle):
    cfg = PCFG.replace(**change)
    assert needle in kernels_unviable_reason(cfg, torch.float32,
                                             torch.device("cpu"))


def test_kernels_viable_on_cpu_and_dtype_checked():
    assert kernels_unviable_reason(PCFG, torch.float32, torch.device("cpu")) is None
    assert "dtype" in kernels_unviable_reason(PCFG, torch.float16,
                                              torch.device("cpu"))


def test_wrappers_refuse_devices_other_than_cpu_and_cuda(layers):
    """Only a CPU tensor takes the plain version; any other device raises
    before a launch is attempted."""
    _, pl = layers
    p_att, p_ffn = pl.kernel_params(torch.float32)
    x = torch.empty((B, S, CFG.hidden_size), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tbb.attention_block(x, p_att, torch.zeros((B, S)), 2)
    with pytest.raises(ValueError, match="CUDA"):
        tbb.ffn_block(x, p_ffn)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_modes_compose_attention_block(layers, dtype):
    """The serving block's three launches on their one-call entry points
    (q/k/v with EPI_BIAS, the core without dropout, the out-projection into
    the float32 residual with EPI_RESID_ROUND), then the LayerNorm, are
    attention_block_plain bit for bit, and agree with the JAX package's
    interpret-mode Pallas attention_block as the plain version does."""
    from realise_tpu_torch.ops import layers as tlayers
    from realise_tpu_torch.ops.kernels import bert_block_train as tbt

    jl, pl = layers
    x, mask = _inputs(seed=5)
    dt = getattr(torch, dtype)
    p, _ = pl.kernel_params(dt)
    bias = tbert.attention_bias_from_mask(torch.tensor(mask), dt)
    xt = _to_t(x, dt)
    h = CFG.hidden_size
    xf = xt.reshape(B * S, h)
    qkv = tbt.forward_gemm(xf, p["qkv_weight"], p["qkv_bias"], tbt.EPI_BIAS)
    ctx = tbt.attention_core(qkv.reshape(B, S, 3 * h), bias, 0,
                             CFG.num_attention_heads)
    z = tbt.forward_gemm(ctx.reshape(B * S, h), p["out_weight"], p["out_bias"],
                         tbt.EPI_RESID_ROUND, xf)
    y = tlayers.layer_norm(z, p["ln_weight"], p["ln_bias"],
                           PCFG.layer_norm_eps).to(dt).reshape(B, S, h)
    assert torch.equal(y, tbb.attention_block_plain(
        xt, p, bias, PCFG.num_attention_heads, PCFG.layer_norm_eps))
    want = _jax_attention(jl, x, mask, getattr(jnp, dtype))
    if dtype == "float32":
        np.testing.assert_allclose(y.numpy(), want, atol=F32_TOL)
    else:
        _assert_bf16_close(y.float().numpy(), want)
