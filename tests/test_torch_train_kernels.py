"""The port's training blocks (realise_tpu_torch/ops/kernels/bert_block_train.py)
against the JAX package's Pallas training kernels in interpret mode.

Inputs are made with numpy from a seed and fed to both packages. On the CPU
the wrappers run their plain versions; the CUDA kernels themselves are held
to those plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py. Masks are compared with the JAX package's default dropout
stream (REALISE_TPU_DROPOUT_SAMPLES unset).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realise_tpu.ops.bert import attention_bias_from_mask
from realise_tpu.ops.layers import dropout as jax_dropout
from realise_tpu.ops.pallas import bert_block_train as jbt
from realise_tpu_torch.ops import layers as tlayers
from realise_tpu_torch.ops.kernels import bert_block_train as tbt

# The JAX package's own tolerance between its train kernels and jax.grad of
# the jnp sub-blocks (tests/test_pallas.py:135).
ATOL = 3e-5


@pytest.fixture(autouse=True)
def _default_dropout_stream(monkeypatch):
    monkeypatch.delenv("REALISE_TPU_DROPOUT_SAMPLES", raising=False)


# ------------------------------------------------------------- the hash
@pytest.mark.parametrize("rows, cols", [(8, 128), (8, 256), (37, 768)])
@pytest.mark.parametrize("keep", [0.9, 0.8])
def test_keep_mask_bit_exact(rows, cols, keep):
    """site_base and keep_mask equal JAX's bit for bit, on both streams
    (two 16-bit samples per hash when cols % 256 == 0, else one 24-bit)."""
    for seed, site, example, head in ((5, 1, 0, 0), (2 ** 31 - 2, 3, 7, 11),
                                      (123, 2, 3, 1), (0, 1, 255, 5)):
        jb = jbt._site_base(jnp.int32(seed), site, jnp.int32(example),
                            head=head)
        tb = tbt.site_base(seed, site, torch.tensor(example),
                           torch.tensor(head))
        assert int(jb) == int(tb)
        want = np.asarray(jbt._keep_mask(jb, rows, cols, keep))
        got = tbt.keep_mask(tb.reshape(1, 1), rows, cols, keep).numpy()
        np.testing.assert_array_equal(got, want)


def test_block_and_probs_masks_bit_exact():
    """The per-example hidden masks and per-(example, head) probability
    masks the blocks apply equal JAX's _block_keep_mask / _keep_mask."""
    seed, b, s, h = 99, 3, 8, 256
    want = np.asarray(jbt._block_keep_mask(jnp.int32(seed), 2, jnp.int32(0),
                                           b, s, h, 0.9))
    got = tbt.block_keep_mask(seed, 2, b, s, h, 0.9, "cpu")
    np.testing.assert_array_equal(got.reshape(b * s, h).numpy(), want)
    probs = tbt.probs_keep_mask(seed, b, 4, s, 0.8, "cpu").numpy()
    for ex in range(b):
        for head in range(4):
            base = jbt._site_base(jnp.int32(seed), 1, jnp.int32(ex), head=head)
            np.testing.assert_array_equal(
                probs[ex, head], np.asarray(jbt._keep_mask(base, s, s, 0.8)))


@pytest.mark.parametrize("rate, shape", [(0.1, (4, 9, 24)), (0.5, (1000,)),
                                         (0.3, (2, 3, 4, 5))])
def test_dropout_matches_jax(rate, shape):
    """layers.dropout given the key words JAX reads equals JAX's dropout."""
    x = np.random.RandomState(0).normal(size=shape).astype(np.float32)
    for key in ((0, 1), (123456789, 4000000000), (2 ** 32 - 1, 7)):
        want = np.asarray(jax_dropout(jnp.asarray(x), rate, False,
                                      jnp.asarray(np.array(key, np.uint32))))
        got = tlayers.dropout(torch.tensor(x), rate, key).numpy()
        np.testing.assert_array_equal(got, want)
    t = torch.tensor(x)
    assert tlayers.dropout(t, 0.0, (1, 2)) is t


def test_random_key_draws_uint32_words():
    gen = torch.Generator().manual_seed(3)
    keys = [tlayers.random_key(gen) for _ in range(50)]
    assert all(0 <= k < 2 ** 32 for pair in keys for k in pair)
    assert len(set(keys)) == 50


# ------------------------------------------------ the train blocks
def _jax_layer(seed, h, inter):
    rng = np.random.RandomState(seed)

    def dense(n_in, n_out):
        return {"kernel": rng.normal(0, n_in ** -0.5,
                                     (n_in, n_out)).astype(np.float32),
                "bias": rng.normal(0, 0.1, (n_out,)).astype(np.float32)}

    def ln(n):
        return {"scale": (1 + rng.normal(0, 0.1, (n,))).astype(np.float32),
                "bias": rng.normal(0, 0.1, (n,)).astype(np.float32)}

    return {"attention": {"query": dense(h, h), "key": dense(h, h),
                          "value": dense(h, h), "output": dense(h, h),
                          "layer_norm": ln(h)},
            "ffn": {"intermediate": dense(h, inter),
                    "output": dense(inter, h), "layer_norm": ln(h)}}


_ATT_NAMES = {"q": "query", "k": "key", "v": "value", "out": "output"}


def _port_params(jl):
    """The same weights as live torch leaves by the train blocks' names."""
    leaf = lambda a: torch.tensor(np.ascontiguousarray(a), requires_grad=True)
    att = {}
    for n, k in _ATT_NAMES.items():
        att[f"{n}_weight"] = leaf(jl["attention"][k]["kernel"].T)
        att[f"{n}_bias"] = leaf(jl["attention"][k]["bias"])
    att["ln_weight"] = leaf(jl["attention"]["layer_norm"]["scale"])
    att["ln_bias"] = leaf(jl["attention"]["layer_norm"]["bias"])
    f = jl["ffn"]
    ffn = {"w1": leaf(f["intermediate"]["kernel"].T),
           "b1": leaf(f["intermediate"]["bias"]),
           "w2": leaf(f["output"]["kernel"].T), "b2": leaf(f["output"]["bias"]),
           "ln_weight": leaf(f["layer_norm"]["scale"]),
           "ln_bias": leaf(f["layer_norm"]["bias"])}
    return att, ffn


def _inputs(b, s, h, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (b, s, h)).astype(np.float32)
    dy = rng.normal(0, 1, (b, s, h)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[1, 5:] = 0  # a padded row
    return x, dy, mask


SIZES = [(3, 8, 16, 2, 32), (2, 8, 256, 4, 512)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("b, s, h, heads, inter", SIZES)
def test_attention_block_train_matches_pallas(b, s, h, heads, inter, rate):
    """Forward y, dx and every parameter gradient of the attention block
    against jax.grad of the interpret-mode Pallas attention_block_train.
    H=256 takes the two-samples-per-hash stream at the output site."""
    jl = _jax_layer(0, h, inter)
    x, dy, mask = _inputs(b, s, h)
    bias = attention_bias_from_mask(jnp.asarray(mask), jnp.float32)
    seed = 77

    def loss(xx, p):
        y = jbt.attention_block_train(xx, p, bias, jnp.array([seed], jnp.int32),
                                      heads, 1e-12, rate, rate, True)
        return jnp.sum(y * dy), y

    (_, want_y), (want_dx, want_g) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jl["attention"])
    att, _ = _port_params(jl)
    xt = torch.tensor(x, requires_grad=True)
    y = tbt.attention_block_train(xt, att, torch.tensor(np.asarray(bias)).reshape(b, s),
                                  seed, heads, 1e-12, rate, rate)
    (y * torch.tensor(dy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), atol=ATOL)
    for n, k in _ATT_NAMES.items():
        np.testing.assert_allclose(att[f"{n}_weight"].grad.numpy().T,
                                   np.asarray(want_g[k]["kernel"]), atol=ATOL)
        np.testing.assert_allclose(att[f"{n}_bias"].grad.numpy(),
                                   np.asarray(want_g[k]["bias"]), atol=ATOL)
    np.testing.assert_allclose(att["ln_weight"].grad.numpy(),
                               np.asarray(want_g["layer_norm"]["scale"]), atol=ATOL)
    np.testing.assert_allclose(att["ln_bias"].grad.numpy(),
                               np.asarray(want_g["layer_norm"]["bias"]), atol=ATOL)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("b, s, h, heads, inter", SIZES)
def test_ffn_block_train_matches_pallas(b, s, h, heads, inter, rate):
    """Forward y, dx and every parameter gradient of the FFN block against
    jax.grad of the interpret-mode Pallas ffn_block_train."""
    jl = _jax_layer(0, h, inter)
    x, dy, _ = _inputs(b, s, h, seed=2)
    seed = 41

    def loss(xx, p):
        y = jbt.ffn_block_train(xx, p, jnp.array([seed], jnp.int32), 1e-12, rate,
                                True)
        return jnp.sum(y * dy), y

    (_, want_y), (want_dx, want_g) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jl["ffn"])
    _, ffn = _port_params(jl)
    xt = torch.tensor(x, requires_grad=True)
    y = tbt.ffn_block_train(xt, ffn, seed, 1e-12, rate)
    (y * torch.tensor(dy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), atol=ATOL)
    pairs = [("w1", ("intermediate", "kernel")), ("b1", ("intermediate", "bias")),
             ("w2", ("output", "kernel")), ("b2", ("output", "bias")),
             ("ln_weight", ("layer_norm", "scale")),
             ("ln_bias", ("layer_norm", "bias"))]
    for name, (sub, leaf) in pairs:
        got = ffn[name].grad.numpy()
        np.testing.assert_allclose(got.T if got.ndim == 2 else got,
                                   np.asarray(want_g[sub][leaf]), atol=ATOL)


def test_train_blocks_pack_once_a_step(monkeypatch):
    """One forward and backward of both train blocks packs each block's
    parameters once: the backward reads the forward's pack."""
    calls = {"attention": 0, "ffn": 0}

    def counted(name, pack):
        def run(params, dtype):
            calls[name] += 1
            return pack(params, dtype)
        return run

    monkeypatch.setattr(tbt, "pack_attention",
                        counted("attention", tbt.pack_attention))
    monkeypatch.setattr(tbt, "pack_ffn", counted("ffn", tbt.pack_ffn))
    att, ffn = _port_params(_jax_layer(7, 16, 32))
    x = torch.tensor(_inputs(2, 8, 16, seed=3)[0], requires_grad=True)
    h = tbt.attention_block_train(x, att, torch.zeros((2, 8)), 5, 2, 1e-12,
                                  0.1, 0.1)
    tbt.ffn_block_train(h, ffn, 5, 1e-12, 0.1).square().sum().backward()
    assert calls == {"attention": 1, "ffn": 1}
    assert all(p.grad is not None for p in [*att.values(), *ffn.values()])


def test_ffn_forward_saves_rounded_z():
    """z is the pre-LN sum rounded to the activation dtype (bf16 here), as
    the Pallas forward stores it, and the backward reads that z."""
    jl = _jax_layer(3, 16, 32)
    _, ffn = _port_params(jl)
    x = torch.tensor(_inputs(2, 8, 16)[0]).to(torch.bfloat16)
    p = tbt.pack_ffn([ffn[k].detach() for k in tbt.FFN_PARAMS], torch.bfloat16)
    y, z = tbt.ffn_train_forward(x, p, 5, 1e-12, 0.1)
    assert y.dtype == z.dtype == torch.bfloat16 and z.shape == x.shape
    want_y, want_z = jbt._ffn_fwd_impl(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jl["ffn"],
        jnp.array([5], jnp.int32), 1e-12, 0.1, True)[:2]
    # One bf16 ulp: the Pallas erf is a polynomial, the port's is exact.
    np.testing.assert_allclose(z.float().numpy(),
                               np.asarray(want_z.astype(jnp.float32)),
                               atol=2 ** -7 * 4, rtol=2 ** -7)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want_y.astype(jnp.float32)),
                               atol=2 ** -7 * 4, rtol=2 ** -7)


def test_dropout_masks_replay_in_backward():
    """With dropout on, the analytic dx equals central differences of the
    forward: the backward replays the forward's masks (and the seed alone
    decides them)."""
    jl = _jax_layer(4, 16, 32)
    att, ffn = _port_params(jl)
    x = torch.tensor(_inputs(2, 8, 16, seed=5)[0]).double()
    bias = torch.zeros((2, 8))
    dy = torch.tensor(_inputs(2, 8, 16, seed=6)[1])

    def f(xx):
        h = tbt.attention_block_train(xx.float(), att, bias, 9, 2, 1e-12, 0.2, 0.2)
        return (tbt.ffn_block_train(h, ffn, 9, 1e-12, 0.2) * dy).sum()

    xt = x.clone().requires_grad_()
    f(xt).backward()
    rng = np.random.RandomState(0)
    for _ in range(4):
        idx = tuple(int(rng.randint(0, d)) for d in x.shape)
        e = torch.zeros_like(x)
        e[idx] = 1e-2
        fd = (f(x + e) - f(x - e)).item() / 2e-2
        assert abs(fd - xt.grad[idx].item()) <= 2e-2 * max(abs(fd), 1.0)
    y1 = tbt.attention_block_train(x.float(), att, bias, 9, 2, 1e-12, 0.3, 0.3)
    y2 = tbt.attention_block_train(x.float(), att, bias, 10, 2, 1e-12, 0.3, 0.3)
    assert not torch.equal(y1, y2)


def test_cpu_wrappers_route_to_plain_and_count_nothing():
    """For CPU tensors the four wrappers ARE their plain versions and never
    count a kernel launch."""
    jl = _jax_layer(5, 16, 32)
    att, ffn = _port_params(jl)
    pa = tbt.pack_attention([att[k].detach() for k in tbt.ATTN_PARAMS], torch.float32)
    pf = tbt.pack_ffn([ffn[k].detach() for k in tbt.FFN_PARAMS], torch.float32)
    x, dy, mask = (torch.tensor(a) for a in _inputs(3, 8, 16, seed=7))
    bias = ((1.0 - mask.float()) * -10000.0)
    before = [fn.launches for fn in tbt.KERNEL_WRAPPERS]
    pairs = [
        (tbt.attention_train_forward(x, pa, bias, 3, 2, 1e-12, 0.1, 0.1),
         tbt.attention_train_forward_plain(x, pa, bias, 3, 2, 1e-12, 0.1, 0.1)),
        (tbt.attention_train_backward(x, dy, pa, bias, 3, 2, 1e-12, 0.1, 0.1)[0],
         tbt.attention_train_backward_plain(x, dy, pa, bias, 3, 2, 1e-12, 0.1,
                                            0.1)[0]),
        (tbt.ffn_train_forward(x, pf, 3, 1e-12, 0.1)[1],
         tbt.ffn_train_forward_plain(x, pf, 3, 1e-12, 0.1)[1]),
        (tbt.ffn_train_backward(x, x, dy, pf, 3, 1e-12, 0.1)[0],
         tbt.ffn_train_backward_plain(x, x, dy, pf, 3, 1e-12, 0.1)[0]),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)
    assert [fn.launches for fn in tbt.KERNEL_WRAPPERS] == before


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    """Only a CPU tensor takes a plain version; a tensor elsewhere raises
    before any launch is attempted (no fallback)."""
    jl = _jax_layer(6, 16, 32)
    att, ffn = _port_params(jl)
    pa = tbt.pack_attention([att[k].detach() for k in tbt.ATTN_PARAMS], torch.float32)
    pf = tbt.pack_ffn([ffn[k].detach() for k in tbt.FFN_PARAMS], torch.float32)
    x = torch.empty((2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tbt.attention_train_forward(x, pa, torch.zeros((2, 8)), 0, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tbt.attention_train_backward(x, x, pa, torch.zeros((2, 8)), 0, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tbt.ffn_train_forward(x, pf, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tbt.ffn_train_backward(x, x, x, pf, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tbt.backward_gemm(x[0], x[0].t(), False)


@pytest.mark.parametrize("transpose_a", [False, True])
def test_backward_gemm_plain_is_the_product(transpose_a):
    """The backward GEMM's plain version (what a CPU tensor gets, and what
    the card's kernel is held to): a float32 weight gradient aᵀ·b over the
    rows, or a data gradient a·b rounded to a's dtype."""
    rng = np.random.RandomState(4)
    a = torch.tensor(rng.normal(0, 1, (37, 24)), dtype=torch.bfloat16)
    b = torch.tensor(rng.normal(0, 1, (37 if transpose_a else 24, 16)),
                     dtype=torch.bfloat16)
    got = tbt.backward_gemm(a, b, transpose_a)
    lhs = a.double().numpy().T if transpose_a else a.double().numpy()
    want = lhs @ b.double().numpy()
    if transpose_a:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.float().numpy(),
            torch.tensor(want, dtype=torch.float32).to(torch.bfloat16).float().numpy())


# --------------------------------------------- one FFN product alone
def _ffn_case(dtype, seed=8):
    jl = _jax_layer(seed, 16, 32)
    _, ffn = _port_params(jl)
    p = tbt.pack_ffn([ffn[k].detach() for k in tbt.FFN_PARAMS], dtype)
    x = torch.tensor(_inputs(2, 8, 16, seed=seed)[0]).to(dtype)
    return jl, p, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_forward_gemm_plain_composes_the_train_forward(dtype, rate):
    """The one-product entry point's plain version, W1 product (dense +
    the exact gelu) then W2 product (the float32 residual with the output
    dropout), is ffn_train_forward_plain's z bit for bit, and its t1 replay
    is dense's t1 with the same gelu bits."""
    _, p, x = _ffn_case(dtype)
    xf = x.reshape(16, 16)
    inter = tbt.forward_gemm(xf, p["w1"], p["b1"], tbt.EPI_BIAS_GELU)
    t1, replay = tbt.forward_gemm(xf, p["w1"], p["b1"], tbt.EPI_BIAS_T1_GELU)
    assert inter.dtype == t1.dtype == dtype
    assert torch.equal(inter, replay)
    assert torch.equal(t1, tlayers.dense(xf, p["w1"], p["b1"]))
    z = tbt.forward_gemm(inter, p["w2"], p["b2"], tbt.EPI_RESID_F32_DROP, xf,
                         seed=5, rows_per_example=8, h_rate=rate)
    assert z.dtype == torch.float32
    want_y, want_z = tbt.ffn_train_forward_plain(x, p, 5, 1e-12, rate)
    assert torch.equal(z.to(dtype), want_z.reshape(16, 16))
    y = tlayers.layer_norm(z, p["ln_weight"], p["ln_bias"], 1e-12).to(dtype)
    assert torch.equal(y, want_y.reshape(16, 16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_gemm_plain_composes_ffn_block(dtype):
    """W1 then W2 without dropout is ffn_block_plain: the residual form bit
    for bit, the erf gelu within one rounding of F.gelu's (the serving plain
    version's; the two evaluate erf differently)."""
    from realise_tpu_torch.ops.kernels import bert_block as tbb

    _, p, x = _ffn_case(dtype, seed=9)
    xf = x.reshape(16, 16)
    inter = tbt.forward_gemm(xf, p["w1"], p["b1"], tbt.EPI_BIAS_GELU)
    ref = torch.nn.functional.gelu(tlayers.dense(xf, p["w1"], p["b1"]).float())
    ulp = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -22
    assert ((inter.float() - ref).abs() <= ulp * ref.abs() + 1e-6).all()
    z = tbt.forward_gemm(ref.to(dtype), p["w2"], p["b2"], tbt.EPI_RESID_F32, xf)
    y = tlayers.layer_norm(z, p["ln_weight"], p["ln_bias"], 1e-12).to(dtype)
    assert torch.equal(y, tbb.ffn_block_plain(x, p).reshape(16, 16))


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_forward_gemm_plain_matches_the_pallas_ffn_forward(rate):
    """The two products composed, then the LayerNorm, against the JAX
    package's interpret-mode Pallas FFN train forward (y and the rounded z)
    on the same weights and inputs, float32."""
    jl, p, x = _ffn_case(torch.float32, seed=10)
    xf = x.reshape(16, 16)
    inter = tbt.forward_gemm(xf, p["w1"], p["b1"], tbt.EPI_BIAS_GELU)
    z = tbt.forward_gemm(inter, p["w2"], p["b2"], tbt.EPI_RESID_F32_DROP, xf,
                         seed=6, rows_per_example=8, h_rate=rate)
    y = tlayers.layer_norm(z, p["ln_weight"], p["ln_bias"], 1e-12)
    want_y, want_z = jbt._ffn_fwd_impl(jnp.asarray(x.numpy()), jl["ffn"],
                                       jnp.array([6], jnp.int32), 1e-12, rate,
                                       True)[:2]
    np.testing.assert_allclose(z.numpy(), np.asarray(want_z).reshape(16, 16),
                               atol=ATOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y).reshape(16, 16),
                               atol=ATOL)


def test_forward_gemm_refuses_other_devices_and_modes():
    """A tensor neither on the CPU nor on CUDA raises before any launch; an
    epilogue that is not an FFN product's raises on the plain path too."""
    _, p, x = _ffn_case(torch.float32)
    meta = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tbt.forward_gemm(meta, meta, meta[0], tbt.EPI_BIAS_GELU)
    with pytest.raises(ValueError, match="mode 7"):
        tbt.forward_gemm(x.reshape(16, 16), p["w2"].t().contiguous(), p["b1"], 7)


# ------------------------- the attention products and core alone
def _attention_case(dtype, seed=11, b=2, s=8, h=16, heads=2):
    jl = _jax_layer(seed, h, 2 * h)
    att, _ = _port_params(jl)
    p = tbt.pack_attention([att[k].detach() for k in tbt.ATTN_PARAMS], dtype)
    x, _, mask = _inputs(b, s, h, seed=seed)
    bias = attention_bias_from_mask(jnp.asarray(mask), jnp.float32)
    return jl, p, torch.tensor(x).to(dtype), bias, heads


def _compose_attention(x, p, bias, seed, heads, rate, mode):
    """q/k/v (EPI_BIAS), the core, then the out-projection into the float32
    residual (``mode``), each on its one-call entry point; y = LN(z)."""
    b, s, h = x.shape
    xf = x.reshape(b * s, h)
    qkv = tbt.forward_gemm(xf, p["qkv_weight"], p["qkv_bias"], tbt.EPI_BIAS)
    ctx = tbt.attention_core(qkv.reshape(b, s, 3 * h), bias, seed, heads, rate)
    z = tbt.forward_gemm(ctx.reshape(b * s, h), p["out_weight"], p["out_bias"],
                         mode, xf, seed=seed, rows_per_example=s, h_rate=rate)
    y = tlayers.layer_norm(z, p["ln_weight"], p["ln_bias"], 1e-12)
    return z, y.to(x.dtype).reshape(b, s, h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_gemm_plain_attention_modes(dtype):
    """The q/k/v and out-projection epilogues of the one-product entry
    point: EPI_BIAS is dense's t = round(a·wᵀ) + b; EPI_RESID_ROUND is x + t
    in float32; EPI_RESID_ROUND_DROP is x + round(t · keep) with the
    attention output site's mask (its default site), and the same as
    EPI_RESID_ROUND without dropout."""
    _, p, x, _, _ = _attention_case(dtype)
    xf = x.reshape(16, 16)
    w, bias = p["out_weight"], p["out_bias"]
    t = tlayers.dense(xf, w, bias)
    assert torch.equal(tbt.forward_gemm(xf, w, bias, tbt.EPI_BIAS), t)
    z = tbt.forward_gemm(xf, w, bias, tbt.EPI_RESID_ROUND, xf)
    assert z.dtype == torch.float32
    assert torch.equal(z, xf.float() + t.float())
    assert torch.equal(tbt.forward_gemm(xf, w, bias, tbt.EPI_RESID_ROUND_DROP,
                                        xf, seed=3, rows_per_example=8), z)
    keep = tbt.block_keep_mask(3, tbt.SITE_ATTN_OUT, 2, 8, 16, 0.8,
                               "cpu").reshape(16, 16)
    zd = tbt.forward_gemm(xf, w, bias, tbt.EPI_RESID_ROUND_DROP, xf, seed=3,
                          rows_per_example=8, h_rate=0.2)
    assert torch.equal(zd, xf.float() + (t.float() * keep).to(dtype).float())
    other = tbt.forward_gemm(xf, w, bias, tbt.EPI_RESID_ROUND_DROP, xf, seed=3,
                             rows_per_example=8, h_rate=0.2,
                             site=tbt.SITE_FFN_OUT)
    assert not torch.equal(other, zd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_attention_modes_compose_the_train_forward(dtype, rate):
    """q/k/v, the core and the dropped out-projection, composed, then the
    LayerNorm, are attention_train_forward_plain bit for bit: the three
    launches of the train forward (and of its backward's recompute)."""
    _, p, x, bias, heads = _attention_case(dtype)
    tbias = torch.tensor(np.asarray(bias)).reshape(2, 8)
    _, y = _compose_attention(x, p, tbias, 5, heads, rate,
                              tbt.EPI_RESID_ROUND_DROP)
    want = tbt.attention_train_forward_plain(x, p, tbias, 5, heads, 1e-12,
                                             rate, rate)
    assert torch.equal(y, want)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_attention_modes_match_the_pallas_attention_forward(rate):
    """The composed launches against the JAX package's interpret-mode Pallas
    attention train forward on the same weights and inputs, float32; H=256
    takes the two-samples-per-hash stream at the output site."""
    jl, p, x, bias, heads = _attention_case(torch.float32, seed=12, h=256,
                                            heads=4)
    tbias = torch.tensor(np.asarray(bias)).reshape(2, 8)
    _, y = _compose_attention(x, p, tbias, 6, heads, rate,
                              tbt.EPI_RESID_ROUND_DROP)
    want = jbt._attn_fwd_impl(jnp.asarray(x.numpy()), jl["attention"], bias,
                              jnp.array([6], jnp.int32), heads, 1e-12, rate,
                              rate, True)[0]
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=ATOL)


def test_attention_core_routes_to_plain_and_refuses_other_devices():
    """For a CPU tensor the core's entry point IS its plain version (the
    forward's ctx); a tensor elsewhere raises before any launch."""
    _, p, x, bias, heads = _attention_case(torch.bfloat16)
    tbias = torch.tensor(np.asarray(bias)).reshape(2, 8)
    qkv = tlayers.dense(x.reshape(16, 16), p["qkv_weight"], p["qkv_bias"])
    ctx = tbt.attention_core(qkv.reshape(2, 8, 48), tbias, 4, heads, 0.2)
    assert ctx.shape == (2, 8, 16) and ctx.dtype == torch.bfloat16
    assert torch.equal(ctx, tbt.attention_core_plain(qkv.reshape(2, 8, 48),
                                                     tbias, 4, heads, 0.2))
    assert torch.equal(ctx.reshape(16, 16),
                       tbt._attn_recompute(x, p, tbias, 4, heads, 0.2, 0.0)[6])
    with pytest.raises(ValueError, match="CUDA"):
        tbt.attention_core(torch.empty((2, 8, 48), device="meta"), tbias, 4,
                           heads)
