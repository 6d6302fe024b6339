"""The port's vocabulary-factorized training streams against the JAX package.

``table_gather``, ``gru_last_hidden_factored`` and the occurrence-weighted
BatchNorm against their JAX functions; the whole tiny arch3 training forward
with the pinyin tables installed and a glyph table whose rows deduplicate,
at B·S above both tables' row counts (the JAX package's padded ones too), so
that both packages factorize; the port's factorized routes against its own
per-token path; the dedup tables' life cycle; the Trainer against the JAX
Trainer. Inputs come from numpy seeds; the model config and tolerances are
those of tests/test_torch_training.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realise_tpu.config import PHO2_VOCAB_SIZE, config_for
from realise_tpu.models.realise import apply_realise, init_realise
from realise_tpu.ops.gru import gru_last_hidden_factored as jax_gru_factored
from realise_tpu.ops.layers import table_gather as jax_table_gather
from realise_tpu.ops.resnet import batch_norm as jax_batch_norm
from realise_tpu.training.trainer import Trainer as JaxTrainer
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.models import realise as trealise
from realise_tpu_torch.models.convert import state_dict_from_jax
from realise_tpu_torch.ops import gru as tgru
from realise_tpu_torch.ops import resnet as tresnet
from realise_tpu_torch.ops.layers import table_gather
from realise_tpu_torch.training import checkpoint as tckpt
from realise_tpu_torch.training.trainer import Trainer
from torch_port_fixtures import live_glyph_features, live_glyph_rows

V, B, S, P = 80, 16, 10, 8
CFG = config_for("bert-pho2-res-arch3", vocab_size=V, hidden_size=16,
                 num_hidden_layers=1, num_attention_heads=2,
                 intermediate_size=32, pho_num_layers=1, out_num_layers=1,
                 max_seq_length=16, max_position_embeddings=16, num_fonts=1,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
PCFG = RealiseConfig.from_dict(CFG.to_dict())
# tests/test_torch_training.py: the mean loss's gradients and the BN
# running statistics against apply_realise.
GRAD_ATOL, BN_ATOL = 5e-5, 1e-5
# Half the vocab renders a glyph, the rest share the zero image: 41 distinct
# rows (the JAX package pads them to 128); 30 distinct pinyin rows (padded to
# 128 there). B·S = 160 exceeds both.
RENDERED, PHO_ROWS = 40, 30


def _np(t):
    return t.detach().float().numpy()


def _glyphs(seed=0):
    rng = np.random.RandomState(seed)
    glyphs = np.zeros((V, 1, 32, 32), np.float32)
    glyphs[:RENDERED] = rng.rand(RENDERED, 1, 32, 32) > 0.5
    return glyphs


def _pho_tables(seed=1):
    rng = np.random.RandomState(seed)
    idx = rng.randint(1, PHO2_VOCAB_SIZE, (PHO_ROWS, P)).astype(np.int32)
    lens = rng.randint(0, P + 1, (PHO_ROWS,)).astype(np.int32)
    pick = rng.randint(0, PHO_ROWS, (V,))
    return idx[pick], lens[pick]


@pytest.fixture(scope="module")
def jax_model():
    rng = np.random.RandomState(0)
    params, state = init_realise(jax.random.PRNGKey(0), CFG, glyphs=_glyphs(),
                                 pho_tables=_pho_tables())
    assert state["res_uniq_images_nhwc"].shape[0] == 128
    assert state["pho_uniq_idx"].shape[0] == 128
    params = live_glyph_features(jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.05, np.shape(x)).astype(np.float32),
        params))
    state = jax.tree.map(np.asarray, state)
    assert live_glyph_rows(_port_model(params, state)) == V
    return params, state


def _port_model(params, state):
    model = trealise.Realise(PCFG)
    model.load_state_dict(state_dict_from_jax(params, state, PCFG))
    model.install_pho_vocab_tables(*_pho_tables())
    return model


def _batch(seed, b=B):
    """Token ids over the whole vocab with the pinyin features the
    Featurizer gathers for them (so the per-token stream sees the rows the
    factorized one scans)."""
    r = np.random.RandomState(seed)
    idx, lens = _pho_tables()
    masks = np.ones((b, S), np.int32)
    masks[1, 6:] = 0
    masks[-1, 4:] = 0
    loss_masks = masks.copy()
    loss_masks[:, 0] = 0
    src = r.randint(0, V, (b, S)).astype(np.int32)
    return {"src_idx": src, "tgt_idx": r.randint(0, V, (b, S)).astype(np.int32),
            "masks": masks, "loss_masks": loss_masks, "pho_idx": idx[src],
            "pho_lens": lens[src]}


def _t(batch):
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.long)
            for k, v in batch.items()}


# ------------------------------------------------------------------ ops
@pytest.mark.parametrize("rows", [80, 8192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_table_gather_matches_jax(rows, dtype):
    """The rows and the table's gradient of a gather with repeated ids
    against the JAX table_gather (its one-hot transpose below 8192 rows,
    its sorted segment sum from 8192). Both sum in float32 and round once:
    in float32 within 1e-5; in bfloat16 the two float32 sums differ in order
    only, so their roundings agree within one bf16 ulp (2^-8 relative)."""
    rng = np.random.RandomState(rows)
    table = rng.normal(0, 1, (rows, 6)).astype(np.float32)
    ids = rng.randint(0, min(rows, 50), (7, 40)).astype(np.int32)
    ct = rng.normal(0, 1, (7, 40, 6)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want, vjp = jax.vjp(lambda t: jax_table_gather(t, jnp.asarray(ids)),
                        jnp.asarray(table, jdt))
    (want_g,) = vjp(jnp.asarray(ct, jdt))
    t = torch.tensor(table).to(getattr(torch, dtype)).requires_grad_()
    got = table_gather(t, torch.as_tensor(ids, dtype=torch.long))
    got.backward(torch.tensor(ct).to(t.dtype))
    assert got.dtype == t.grad.dtype == t.dtype
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(
        rtol=2.0 ** -8, atol=1e-6)
    np.testing.assert_allclose(_np(t.grad), np.asarray(want_g, np.float32),
                               **tol)
    first = t.grad.clone()
    t.grad = None
    table_gather(t, torch.as_tensor(ids, dtype=torch.long)).backward(
        torch.tensor(ct).to(t.dtype))
    assert torch.equal(first, t.grad)  # the same bits twice


def _gru_inputs(seed=3, n=40, a=33, d=12, h=12):
    rng = np.random.RandomState(seed)
    params = {"w_ih": rng.normal(0, 0.3, (d, 3 * h)).astype(np.float32),
              "w_hh": rng.normal(0, 0.3, (h, 3 * h)).astype(np.float32),
              "b_ih": rng.normal(0, 0.1, (3 * h,)).astype(np.float32),
              "b_hh": rng.normal(0, 0.1, (3 * h,)).astype(np.float32)}
    emb = rng.normal(0, 1, (a, d)).astype(np.float32)
    idx = rng.randint(0, a, (n, P)).astype(np.int32)
    lens = rng.randint(0, P + 1, (n,)).astype(np.int32)
    ct = rng.normal(0, 1, (n, h)).astype(np.float32)
    return params, emb, idx, lens, ct


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_last_hidden_factored_matches_jax(dtype):
    """Hiddens and the gradients of <hiddens, ct> for the four GRU weights
    and the embedding table. float32: 1e-5. bfloat16: the hiddens within
    2^-5 (8 ulps at |h| < 1): XLA keeps the float32 intermediates of each
    fused elementwise step where torch rounds every op to bf16, and eight
    steps compound those roundings (3 ulps seen); the gradients within 2^-4
    of each tensor's largest value, since JAX also rounds tw's gradient to
    bf16 at every step and sums the steps in bf16, where the port sums them
    in float32 and rounds once."""
    params, emb, idx, lens, ct = _gru_inputs()
    jdt = jnp.dtype(dtype)

    def jfn(p, e):
        return jax_gru_factored(p, e.astype(jdt), jnp.asarray(idx),
                                jnp.asarray(lens))

    jp = jax.tree.map(jnp.asarray, params)
    want, vjp = jax.vjp(jfn, jp, jnp.asarray(emb))
    jg, je = vjp(jnp.asarray(ct, jdt))
    tp = {k: torch.tensor(v.T if v.ndim == 2 else v).requires_grad_()
          for k, v in params.items()}
    te = torch.tensor(emb).requires_grad_()
    got = tgru.gru_last_hidden_factored(
        tp["w_ih"], tp["w_hh"], tp["b_ih"], tp["b_hh"],
        te.to(getattr(torch, dtype)), torch.as_tensor(idx, dtype=torch.long),
        torch.as_tensor(lens, dtype=torch.long))
    got.backward(torch.tensor(ct).to(got.dtype))
    pairs = [(got, want), (te.grad, je)] + [
        (tp[k].grad, np.asarray(jg[k]).T if np.ndim(jg[k]) == 2 else jg[k])
        for k in params]
    for i, (g, w) in enumerate(pairs):
        w = np.asarray(w, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(_np(g), w, atol=1e-5, err_msg=str(i))
        elif i == 0:
            np.testing.assert_allclose(_np(g), w, atol=2.0 ** -5)
        else:
            np.testing.assert_allclose(_np(g), w,
                                       atol=2.0 ** -4 * np.abs(w).max(),
                                       err_msg=str(i))


def test_gru_factored_matches_the_unfolded_scan():
    """Folding the input projection through the alphabet computes
    gru_last_hidden of the embedded ids (float32, 1e-5)."""
    params, emb, idx, lens, _ = _gru_inputs(seed=4)
    w = {k: torch.tensor(v.T if v.ndim == 2 else v) for k, v in params.items()}
    ids, n = torch.as_tensor(idx, dtype=torch.long), torch.as_tensor(lens)
    e = torch.tensor(emb)
    folded = tgru.gru_last_hidden_factored(w["w_ih"], w["w_hh"], w["b_ih"],
                                           w["b_hh"], e, ids, n)
    plain = tgru.gru_last_hidden(w["w_ih"], w["w_hh"], w["b_ih"], w["b_hh"],
                                 e[ids], n)
    np.testing.assert_allclose(_np(folded), _np(plain), atol=1e-5)


def _bn_pair(seed, c=6):
    rng = np.random.RandomState(seed)
    p = {"scale": rng.normal(1, 0.2, (c,)).astype(np.float32),
         "bias": rng.normal(0, 0.2, (c,)).astype(np.float32)}
    st = {"mean": rng.normal(0, 0.2, (c,)).astype(np.float32),
          "var": rng.uniform(0.5, 1.5, (c,)).astype(np.float32)}
    bn = torch.nn.BatchNorm2d(c, eps=tresnet.BN_EPS).train()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(p["scale"]))
        bn.bias.copy_(torch.tensor(p["bias"]))
        bn.running_mean.copy_(torch.tensor(st["mean"]))
        bn.running_var.copy_(torch.tensor(st["var"]))
    return p, st, bn


def test_weighted_batch_norm_matches_jax():
    """Output and running statistics of the weighted batch norm (counts with
    zeros among them) against the JAX batch_norm, float32, 1e-5."""
    rng = np.random.RandomState(5)
    x = (rng.normal(0, 2, (9, 6, 4, 4)) + 1).astype(np.float32)
    w = np.array([3, 0, 1, 7, 2, 0, 1, 1, 4], np.float32)
    p, st, bn = _bn_pair(6)
    want, want_st = jax_batch_norm(p, st, jnp.asarray(x.transpose(0, 2, 3, 1)),
                                   True, jnp.asarray(w))
    got = tresnet.batch_norm(bn, torch.tensor(x), torch.tensor(w))
    np.testing.assert_allclose(_np(got), np.asarray(want).transpose(0, 3, 1, 2),
                               atol=1e-5)
    np.testing.assert_allclose(_np(bn.running_mean), want_st["mean"], atol=1e-5)
    np.testing.assert_allclose(_np(bn.running_var), want_st["var"], atol=1e-5)
    assert int(bn.num_batches_tracked) == 1


def test_weighted_batch_norm_is_the_repeated_batch():
    """Row n weighted by k equals a batch holding row n k times: outputs of
    the rows, the running statistics (1e-5), and the gradients of the input
    rows (summed over the copies) and of the scale and shift."""
    rng = np.random.RandomState(7)
    x = torch.tensor((rng.normal(0, 2, (5, 6, 3, 3)) + 1).astype(np.float32))
    counts = torch.tensor([2, 1, 0, 4, 1])
    _, _, bn_w = _bn_pair(8)
    _, _, bn_r = _bn_pair(8)
    xw = x.clone().requires_grad_()
    xr = x.clone().requires_grad_()
    yw = tresnet.batch_norm(bn_w, xw, counts.float())
    rep = torch.repeat_interleave(torch.arange(5), counts)
    yr = tresnet.batch_norm(bn_r, xr[rep])
    np.testing.assert_allclose(_np(yw[rep]), _np(yr), atol=1e-5)
    ct = torch.tensor(rng.normal(0, 1, tuple(yr.shape)).astype(np.float32))
    (yr * ct).sum().backward()
    (yw * torch.zeros_like(yw).index_add_(0, rep, ct)).sum().backward()
    for a, b in ((xw.grad, xr.grad), (bn_w.weight.grad, bn_r.weight.grad),
                 (bn_w.bias.grad, bn_r.bias.grad),
                 (bn_w.running_mean, bn_r.running_mean),
                 (bn_w.running_var, bn_r.running_var)):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_batch_norm_is_the_float64_function(weighted):
    """Output and the gradients of x, the scale and the shift against
    autograd of the same batch norm in float64, for a channel whose mean is
    50 times its spread (what a ReLU and many rows of one shared glyph
    give): within 1e-5 of each tensor's largest value, float32 rounding of
    the inputs and outputs only."""
    rng = np.random.RandomState(11)
    x = (50.0 + rng.normal(0, 1, (7, 4, 3, 3))).astype(np.float32)
    w = np.array([3, 0, 1, 5, 2, 1, 1], np.float32) if weighted else np.ones(7, np.float32)
    ct = rng.normal(0, 1, x.shape).astype(np.float32)
    _, _, bn = _bn_pair(12, c=4)
    xt = torch.tensor(x, requires_grad=True)
    y = tresnet.batch_norm(bn, xt, torch.tensor(w) if weighted else None)
    (y * torch.tensor(ct)).sum().backward()
    x64 = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    g64 = bn.weight.detach().double().requires_grad_()
    b64 = bn.bias.detach().double().requires_grad_()
    w64 = torch.tensor(w, dtype=torch.float64)[:, None, None, None]
    tot = w64.sum() * 9
    mean = (x64 * w64).sum((0, 2, 3)) / tot
    var = ((x64 - mean[:, None, None]) ** 2 * w64).sum((0, 2, 3)) / tot
    want = ((x64 - mean[:, None, None]) * torch.rsqrt(var + tresnet.BN_EPS)[:, None, None]
            * g64[:, None, None] + b64[:, None, None])
    (want * torch.tensor(ct, dtype=torch.float64)).sum().backward()
    for got, ref in ((y, want), (xt.grad, x64.grad), (bn.weight.grad, g64.grad),
                     (bn.bias.grad, b64.grad)):
        ref = ref.detach().numpy()
        np.testing.assert_allclose(_np(got), ref, atol=1e-5 * np.abs(ref).max())


# ------------------------------------------------------------ whole model
@pytest.fixture(scope="module")
def jax_step(jax_model):
    """apply_realise(train=True, use_pallas=True) with the tables installed:
    (loss sum, count, gradients of the mean loss, new BN state)."""
    params, state = jax_model
    batch = {k: jnp.asarray(v) for k, v in _batch(1).items()}

    def loss(p):
        out = apply_realise(p, state, batch, CFG, deterministic=False,
                            rng=jax.random.PRNGKey(3), train=True,
                            use_pallas=True)
        return out["loss"], (out["loss_sum"], out["loss_count"], out["state"])

    (_, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    return aux + (grads,)


def _port_step(model, batch, **kw):
    """(loss sum, count, {name: mean-loss gradient}, {BN buffer}) of one
    training forward and backward."""
    model.train().zero_grad(set_to_none=True)
    out = model(_t(batch), generator=torch.Generator().manual_seed(1), **kw)
    assert "logits" not in out
    (out["loss_sum"] / out["loss_count"]).backward()
    return (out["loss_sum"].item(), out["loss_count"].item(),
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers() if "running_" in n})


@pytest.mark.parametrize("batch_rows", [False, True])
@pytest.mark.parametrize("kernels", [True, False])
def test_factorized_training_forward_matches_apply_realise(jax_model, jax_step,
                                                           kernels, batch_rows):
    """Loss, every gradient and the BN running statistics of the port's
    factorized forward (the conv over every distinct glyph row, or over the
    batch's own rows counted on the host) against apply_realise's factorized
    one: loss rtol 1e-6, gradients atol 5e-5, BN atol 1e-5."""
    params, state = jax_model
    ls, lc, new_state, grads = jax_step
    model = _port_model(params, state)
    batch = _batch(1)
    assert B * S > 128 > model.res_conv_rows and model.pho_uniq_idx.shape[0] < 128
    if batch_rows:
        batch.update(model.conv_rows(batch["src_idx"]))
        assert len(batch["res_rows"]) < model.res_conv_rows
    loss, count, got, bn = _port_step(model, batch, use_kernels=kernels)
    assert count == float(lc)
    np.testing.assert_allclose(loss, float(ls), rtol=1e-6)
    want = state_dict_from_jax(jax.tree.map(np.asarray, grads), state, PCFG)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL, err_msg=name)
    want_state = state_dict_from_jax(params, jax.tree.map(np.asarray, new_state),
                                     PCFG)
    for name, buf in bn.items():
        np.testing.assert_allclose(buf.numpy(), want_state[name].numpy(),
                                   atol=BN_ATOL, err_msg=name)


@pytest.mark.parametrize("route", ["vocab_rows", "batch_rows"])
def test_factorized_matches_per_token(jax_model, route):
    """The port's factorized streams against its own per-token path with
    tests/test_model.py:276-287's tolerances: loss rtol 1e-6, gradients
    atol 1e-5, BN statistics rtol 1e-5 + atol 1e-6; in eval mode the logits
    atol 1e-5."""
    params, state = jax_model
    model = _port_model(params, state)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _batch(2)
    tok = _port_step(model, batch, per_token=True)
    model.load_state_dict(sd)
    if route == "batch_rows":
        batch.update(model.conv_rows(batch["src_idx"]))
    fac = _port_step(model, batch)
    np.testing.assert_allclose(fac[0], tok[0], rtol=1e-6)
    for name in tok[2]:
        np.testing.assert_allclose(fac[2][name].numpy(), tok[2][name].numpy(),
                                   atol=1e-5, err_msg=name)
    for name in tok[3]:
        np.testing.assert_allclose(fac[3][name].numpy(), tok[3][name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    model.load_state_dict(sd)
    with torch.inference_mode():
        e_fac = model.eval()(_t(batch))["logits"]
        e_tok = model(_t(batch), per_token=True)["logits"]
    np.testing.assert_allclose(_np(e_fac), _np(e_tok), atol=1e-5)


def test_glyph_tables_follow_the_glyphs(jax_model, tmp_path):
    """The dedup tables are derived, not saved: state_dict() keeps the
    reference's keys, a checkpoint loads with strict=True, and the tables
    follow whatever glyphs were installed or loaded last. A re-install of
    glyphs that barely share drops the previous tables (the JAX package's
    stale-dedup fault, tests/test_model.py:535)."""
    params, state = jax_model
    model = _port_model(params, state)
    keys = set(state_dict_from_jax(params, state, PCFG))
    assert set(model.state_dict()) == keys
    assert model.res_conv_rows == RENDERED + 1
    glyphs = model.char_images_multifonts
    first = model.res_uniq_first
    np.testing.assert_array_equal(
        glyphs[first][model.res_uniq_inverse].numpy(), glyphs.numpy())
    distinct = np.random.RandomState(9).rand(V, 1, 32, 32).astype(np.float32)
    model.install_glyphs(distinct)
    assert model.res_uniq_first is None and model.res_uniq_inverse is None
    assert model.res_conv_rows == V
    # A checkpoint of the shared glyphs loads strictly and brings its tables.
    path = tckpt.save_checkpoint(str(tmp_path), 1,
                                 state_dict_from_jax(params, state, PCFG), PCFG)
    model.load_state_dict(tckpt.load_checkpoint(path), strict=True)
    assert model.res_conv_rows == RENDERED + 1
    with torch.device("meta"):
        lazy = trealise.Realise(PCFG)
    lazy.load_state_dict(tckpt.load_checkpoint(path), assign=True)
    assert torch.equal(lazy.res_uniq_inverse, model.res_uniq_inverse)
    assert set(lazy.state_dict()) == keys
    # Loaded glyphs that barely share leave no tables behind either.
    sd = model.state_dict()
    sd["char_images_multifonts"] = torch.tensor(distinct)
    model.load_state_dict(sd)
    assert model.res_uniq_first is None and model.res_conv_rows == V


def test_conv_rows_are_the_calls_distinct_rows(jax_model):
    params, state = jax_model
    model = _port_model(params, state)
    src = _batch(3)["src_idx"]
    got = model.conv_rows(src)
    glyph_row = model.res_uniq_inverse.numpy()[src]
    distinct = np.unique(glyph_row)
    rows = got["res_rows"]
    assert len(rows) == trealise.row_bucket(len(distinct)) >= len(distinct)
    np.testing.assert_array_equal(rows[:len(distinct)], distinct)
    assert (rows[len(distinct):] == distinct[-1]).all()
    np.testing.assert_array_equal(rows[got["res_inverse"]], glyph_row)
    assert got["res_inverse"].max() < len(distinct)
    assert got["res_inverse"].shape == src.shape


@pytest.mark.parametrize("n,want", [(1, 1), (15, 15), (16, 16), (17, 18),
                                    (1739, 1792), (2049, 2304), (6604, 6656)])
def test_row_bucket(n, want):
    assert trealise.row_bucket(n) == want


# -------------------------------------------------------------- trainer
def test_trainer_matches_jax_trainer(jax_model):
    """Three steps of the Trainer with grad_accum_steps=2 against the JAX
    Trainer(use_pallas=True), both factorizing (each microbatch's 160 token
    slots exceed both tables' rows); the tolerances of
    tests/test_torch_training.py's Trainer test."""
    params, state = jax_model
    batches = [_batch(10 + i, b=2 * B) for i in range(3)]
    kw = dict(learning_rate=1e-5, warmup_steps=1, total_steps=10,
              weight_decay=0.01, max_grad_norm=1.0, grad_accum_steps=2)
    jt = JaxTrainer(CFG, jax.tree.map(jnp.asarray, params),
                    jax.tree.map(jnp.asarray, state), use_pallas=True, **kw)
    want_loss = [float(jt.train_step(b)) for b in batches]
    tt = Trainer(PCFG, _port_model(params, state), use_kernels=True,
                 device="cpu", **kw)
    got_loss = [float(tt.train_step(b)) for b in batches]
    np.testing.assert_allclose(got_loss, want_loss, atol=1e-5)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jt.train_state.params),
                               jax.tree.map(np.asarray, jt.train_state.state),
                               PCFG)
    lr_sum = sum(tt.schedule(i) for i in range(3))
    diffs = []
    for name, p in tt.model.named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy())
        assert d.max() <= 2 * lr_sum, (name, d.max())
        diffs.append(d.ravel())
    assert (np.concatenate(diffs) > 1e-6).mean() < 1e-3
    for name, buf in tt.model.named_buffers():
        if "running_" in name:
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                       atol=5e-5, err_msg=name)


def test_trainer_counts_conv_rows_on_the_host(jax_model, monkeypatch):
    """The Trainer's step hands each microbatch its own distinct glyph rows,
    counted with numpy: no torch.unique runs in the step, and the model gets
    the rows of its half of the batch."""
    params, state = jax_model
    tt = Trainer(PCFG, _port_model(params, state), use_kernels=False,
                 device="cpu", grad_accum_steps=2)
    seen = []
    forward = tt.model.forward
    monkeypatch.setattr(tt.model, "forward", lambda mb, **kw: (
        seen.append({k: v.clone() for k, v in mb.items()}), forward(mb, **kw))[1])

    def refuse(*a, **k):
        raise AssertionError("torch.unique in the training step")

    monkeypatch.setattr(torch, "unique", refuse)
    monkeypatch.setattr(torch.Tensor, "unique", refuse)
    batch = _batch(4, b=2 * B)
    assert np.isfinite(float(tt.train_step(batch)))
    assert len(seen) == 2
    for i, mb in enumerate(seen):
        half = batch["src_idx"][i * B:(i + 1) * B]
        want = tt.model.conv_rows(half)
        np.testing.assert_array_equal(mb["res_rows"].numpy(), want["res_rows"])
        np.testing.assert_array_equal(mb["res_inverse"].numpy(),
                                      want["res_inverse"])
