"""The port's CUDA kernels on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA device:
a CUDA kernel has no CPU mode. The file imports nothing of JAX, so it runs on
a machine that has the card and PyTorch alone (the repository's conftest
imports JAX, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:randomly \\
        --noconftest -o addopts=""
"""

import copy
import io

import numpy as np
import pytest
import torch

from realise_tpu_torch.config import config_for
from realise_tpu_torch.device import resolve_device
from realise_tpu_torch.models.realise import Realise, RealisePretrain
from realise_tpu_torch.ops import bert as tbert
from realise_tpu_torch.ops.kernels import bert_block as tbb
from realise_tpu_torch.ops.kernels import bert_block_train as tbt
from realise_tpu_torch.training import optim as toptim
from realise_tpu_torch.training.checkpoint import save_checkpoint
from realise_tpu_torch.training.trainer import Trainer
from realise_tpu_torch.utils.profiler import SpanRecorder

pytestmark = pytest.mark.cuda

# Max |kernel - plain|, as in chip_smoke.py: float32 differs only in the
# order of sums; bfloat16 outputs (|y| up to ~4) may differ by two ulps.
TOL = {"float32": 1e-4, "bfloat16": 6.25e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _layer(hidden, heads, seed=0):
    """A BertLayer with every parameter random, biases and LayerNorm too."""
    cfg = config_for("bert-pho2-res-arch3", hidden_size=hidden,
                     num_attention_heads=heads, intermediate_size=2 * hidden)
    layer = tbert.BertLayer(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            if "LayerNorm.weight" in name:
                p.normal_(1.0, 0.1, generator=gen)
            elif p.dim() == 2:
                p.normal_(0.0, hidden ** -0.5, generator=gen)
            else:
                p.normal_(0.0, 0.1, generator=gen)
    return layer


# Train kernels against their plain versions, max |kernel - plain| relative
# to the largest |plain| of each tensor: float32 differs only in the order of
# sums; in bfloat16 a one-ulp flip of a rounded intermediate (a probability,
# a softmax gradient, a gelu) moves its consumers by about an ulp of the
# result, 2^-8 of its largest value, so allow four such ulps.
TRAIN_REL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}


def _rel_err(got, want):
    want = want.float()
    return ((got.float() - want).abs().max() /
            want.abs().max().clamp_min(1e-30)).item()


def _train_params(layer):
    """The layer's live parameters in ATTN_PARAMS and FFN_PARAMS order."""
    att, ffn = layer.block_params()
    return ([att[k] for k in tbt.ATTN_PARAMS],
            [ffn[k] for k in tbt.FFN_PARAMS])


def _tiny_cfg(dtype):
    # head_dim 64: the bf16 attention core takes its tensor-core route.
    return config_for("bert-pho2-res-arch3", vocab_size=300, hidden_size=128,
                      num_hidden_layers=2, num_attention_heads=2,
                      intermediate_size=256, pho_num_layers=1,
                      out_num_layers=1, num_fonts=1, dtype=dtype)


def _reset_launches():
    tbb.attention_block.launches = 0
    tbb.ffn_block.launches = 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["attention_block", "ffn_block"])
@pytest.mark.parametrize("hidden, heads", [(16, 2), (128, 2)])
def test_kernel_matches_plain(cuda_device, kernel, dtype, hidden, heads):
    """Each kernel against its plain version, ragged sequence lengths and
    padded rows included; garbage in padded positions leaves the valid rows
    bit for bit as they were."""
    dt = getattr(torch, dtype)
    p_att, p_ffn = _layer(hidden, heads).to(cuda_device).kernel_params(dt)
    rng = np.random.RandomState(5)
    for b, s in ((3, 8), (3, 37), (2, 128)):
        x = torch.tensor(rng.normal(0, 1, (b, s, hidden)).astype(np.float32))
        x = x.to(cuda_device, dt)
        mask = torch.ones((b, s), dtype=torch.long, device=cuda_device)
        mask[1, s // 2:] = 0
        bias = tbert.attention_bias_from_mask(mask, dt)
        if kernel == "attention_block":
            run = lambda t: tbb.attention_block(t, p_att, bias, heads)
            plain = lambda t: tbb.attention_block_plain(t, p_att, bias, heads)
        else:
            run = lambda t: tbb.ffn_block(t, p_ffn)
            plain = lambda t: tbb.ffn_block_plain(t, p_ffn)
        got = run(x)
        torch.cuda.synchronize()
        err = (got.float() - plain(x).float()).abs().max().item()
        assert err <= TOL[dtype], (b, s, err)
        garbage = x.clone()
        garbage[mask == 0] = 99.0
        valid = mask.bool()
        assert torch.equal(run(garbage)[valid], got[valid])


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    layer = _layer(16, 2).to(cuda_device)
    p_att, p_ffn = layer.kernel_params(torch.float32)
    x = torch.randn((2, 8, 16), device=cuda_device)
    bias = torch.zeros((2, 8), device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        tbb.ffn_block(x.half(), p_ffn)
    with pytest.raises(ValueError, match="contiguous"):
        tbb.ffn_block(x.transpose(0, 1), p_ffn)
    with pytest.raises(ValueError, match="qkv_weight: dtype"):
        tbb.attention_block(x, layer.kernel_params(torch.bfloat16)[0], bias, 2)
    with pytest.raises(ValueError, match="S <= 128"):
        tbb.attention_block(torch.randn((1, 129, 16), device=cuda_device),
                            p_att, torch.zeros((1, 129), device=cuda_device), 2)


def test_model_kernel_path_matches_plain_path(cuda_device):
    """The whole arch3 forward on the card in float32 (per-token GRU and
    conv streams): every encoder layer goes through both kernels, and the
    logits match the plain sub-blocks'."""
    cfg = _tiny_cfg("float32")
    gen = torch.Generator().manual_seed(0)
    model = Realise(cfg, generator=gen)
    model.install_glyphs((torch.rand(model.char_images_multifonts.shape,
                                     generator=gen) < 0.5).float())
    model = model.to(cuda_device).eval()
    rng = np.random.RandomState(1)
    b, s, p = 3, 37, cfg.pho2_max_len
    masks = np.ones((b, s), np.int64)
    masks[1, 20:] = 0
    batch = {"src_idx": rng.randint(0, cfg.vocab_size, (b, s)),
             "masks": masks,
             "pho_idx": rng.randint(1, 30, (b, s, p)),
             "pho_lens": rng.randint(0, p + 1, (b, s))}
    batch = {k: torch.as_tensor(v, dtype=torch.long, device=cuda_device)
             for k, v in batch.items()}
    _reset_launches()
    with torch.inference_mode():
        got = model(batch, use_kernels=True)["logits"]
        layers = (tbb.attention_block.launches, tbb.ffn_block.launches)
        want = model(batch, use_kernels=False)["logits"]
    assert layers == (4, 4)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("stage", ["pho2-pretrain", "pho2-res-pretrain"])
def test_pretraining_kernel_path_matches_plain_path(cuda_device, stage):
    """A pretraining stage on the card in float32 at dropout 0: the eval
    logits and a train step's loss and gradients on the kernel path against
    the plain path (chip_smoke.py phase 8's limits: loss 1e-5 relative,
    each gradient 1.5e-3 of its largest |value|), and one launch of each
    kernel per pho BERT layer and call. The kernels reach the glyph
    stream through the gradient of its features, which is held to the same
    limit. Its weights' gradients pass the BatchNorm backward, whose mean
    subtractions over this batch's 111 images cancel most of each sum, so
    the float32 order differences upstream reach 1.3e-3 to 1.7e-3 of the
    first shortcut conv's largest gradient, and two calls of one path read
    6.7e-4 to 2.1e-3 apart (cuDNN's float32 weight gradients;
    tools/glyph_grad_probe.py, H100). chip_smoke.py phase 12 holds those
    weights' gradients to the limit at the published widths over 4096
    images, where the probe reads 2.7e-4 to 4.3e-4. The model reaches the
    card through resolve_device, as the entry points' models do, which
    turns cuDNN's TF32 convolutions off (on: 1.9e-2 at this batch)."""
    cfg = config_for(stage, vocab_size=300, hidden_size=128,
                     num_attention_heads=2, intermediate_size=256,
                     pho_num_layers=2, num_fonts=1, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    gen = torch.Generator().manual_seed(0)
    model = RealisePretrain(cfg, generator=gen)
    if cfg.with_res:
        model.install_glyphs((torch.rand(model.char_images_multifonts.shape,
                                         generator=gen) < 0.5).float())
    model = model.to(resolve_device(cuda_device))
    rng = np.random.RandomState(2)
    b, s, p = 3, 37, cfg.pho2_max_len
    masks = np.ones((b, s), np.int64)
    masks[1, 20:] = 0
    src = rng.randint(0, cfg.vocab_size, (b, s))
    batch = {"src_idx": src, "tgt_idx": src, "masks": masks,
             "loss_masks": masks * (rng.rand(b, s) < 0.8),
             "pho_idx": rng.randint(1, 30, (b, s, p)),
             "pho_lens": rng.randint(0, p + 1, (b, s))}
    batch = {k: torch.as_tensor(v, dtype=torch.long, device=cuda_device)
             for k, v in batch.items()}
    _reset_launches()
    for fn in tbt.KERNEL_WRAPPERS:
        fn.launches = 0
    with torch.inference_mode():
        got = model.eval()(batch, use_kernels=True)["logits"]
        want = model(batch, use_kernels=False)["logits"]
    assert (tbb.attention_block.launches, tbb.ffn_block.launches) == (2, 2)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    feats_grad = {}

    def keep_feature_grad(module, args, feats):
        feats.register_hook(
            lambda g: feats_grad.__setitem__("glyph features", g.clone()))

    if cfg.with_res:
        model.resnet.register_forward_hook(keep_feature_grad)
    results = []
    for use_kernels in (True, False):
        model.load_state_dict(state)
        model.train().zero_grad(set_to_none=True)
        out = model(batch, use_kernels=use_kernels,
                    generator=torch.Generator().manual_seed(0))
        out["loss_sum"].backward()
        grads = {n: q.grad.clone() for n, q in model.named_parameters()
                 if not n.startswith("resnet.")}
        results.append((out["loss_sum"].item(), dict(grads, **feats_grad)))
    assert [fn.launches for fn in tbt.KERNEL_WRAPPERS] == [2, 2, 2, 2]
    (loss_k, grads_k), (loss_p, grads_p) = results
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    floor = 1e-4 * max(g.abs().max().item() for g in grads_p.values())
    for name, g in grads_p.items():
        err = (grads_k[name] - g).abs().max().item()
        assert err <= 1.5e-3 * max(g.abs().max().item(), floor), (name, err)


def test_cli_correct_on_cuda(cuda_device, tmp_path, monkeypatch, capsys):
    """cli/correct with its defaults (CUDA, kernels on) over a bf16
    checkpoint and the synthetic vocab."""
    from realise_tpu_torch.cli import correct

    cfg = _tiny_cfg("bfloat16")
    save_checkpoint(str(tmp_path), 0, Realise(cfg).state_dict(), cfg)
    monkeypatch.setattr("sys.stdin", io.StringIO("我爱北经。\n天气很好\n"))
    _reset_launches()
    assert correct.main(["--ckpt_dir", str(tmp_path), "--synthetic",
                         "--show_edits"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [len(ln.split("\t")[0]) for ln in lines] == [5, 4]
    assert tbb.attention_block.launches == tbb.ffn_block.launches == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("hidden, heads", [(16, 2), (256, 4)])
def test_train_kernels_match_plain(cuda_device, dtype, rate, hidden, heads):
    """The four train kernels (forward y and z, backward dx and every
    parameter gradient) against their plain versions, padded rows included;
    H=256 takes the two-samples-per-hash dropout stream at the hidden sites,
    and head_dim 64 the bf16 tensor-core attention cores (forward and
    backward) and the backward's Hopper GEMM at S = 37, 64 and 128 (B*S =
    74 rows: a ragged tile edge)."""
    dt = getattr(torch, dtype)
    att_p, ffn_p = _train_params(_layer(hidden, heads).to(cuda_device))
    pa, pf = tbt.pack_attention(att_p, dt), tbt.pack_ffn(ffn_p, dt)
    rng = np.random.RandomState(7)
    for b, s in ((3, 8), (2, 37), (2, 64), (2, 128)):
        x = torch.tensor(rng.normal(0, 1, (b, s, hidden)).astype(np.float32))
        dy = torch.tensor(rng.normal(0, 1, (b, s, hidden)).astype(np.float32))
        x, dy = x.to(cuda_device, dt), dy.to(cuda_device, dt)
        mask = torch.ones((b, s), dtype=torch.long, device=cuda_device)
        mask[1, s // 2:] = 0
        bias = tbert.attention_bias_from_mask(mask, dt).reshape(b, s).float()
        seed = 12345 + s
        cases = [
            ("attention fwd",
             tbt.attention_train_forward(x, pa, bias, seed, heads, 1e-12, rate, rate),
             tbt.attention_train_forward_plain(x, pa, bias, seed, heads, 1e-12, rate,
                                               rate))]
        dx, g = tbt.attention_train_backward(x, dy, pa, bias, seed, heads, 1e-12,
                                             rate, rate)
        dx0, g0 = tbt.attention_train_backward_plain(x, dy, pa, bias, seed, heads,
                                                     1e-12, rate, rate)
        cases += [("attention dx", dx, dx0)] + [
            (f"attention d{k}", g[k], g0[k]) for k in g0]
        (y, z), (y0, z0) = (tbt.ffn_train_forward(x, pf, seed, 1e-12, rate),
                            tbt.ffn_train_forward_plain(x, pf, seed, 1e-12, rate))
        cases += [("ffn y", y, y0), ("ffn z", z, z0)]
        dx, g = tbt.ffn_train_backward(x, z0, dy, pf, seed, 1e-12, rate)
        dx0, g0 = tbt.ffn_train_backward_plain(x, z0, dy, pf, seed, 1e-12, rate)
        cases += [("ffn dx", dx, dx0)] + [(f"ffn d{k}", g[k], g0[k]) for k in g0]
        torch.cuda.synchronize()
        for name, got, want in cases:
            assert got.shape == want.shape and got.dtype == want.dtype, name
            err = _rel_err(got, want)
            assert err <= TRAIN_REL[dtype], (name, b, s, err)


def test_train_blocks_count_launches_and_reach_the_parameters(cuda_device):
    """The autograd Functions launch each train kernel once per call and
    leave float32 gradients on the live parameters."""
    layer = _layer(128, 2).to(cuda_device)
    att_p, ffn_p = _train_params(layer)
    x = torch.randn((2, 37, 128), device=cuda_device, requires_grad=True)
    bias = torch.zeros((2, 37), device=cuda_device)
    for fn in tbt.KERNEL_WRAPPERS:
        fn.launches = 0
    h = tbt.attention_block_train(x, dict(zip(tbt.ATTN_PARAMS, att_p)), bias, 3,
                                  2, 1e-12, 0.1, 0.1)
    y = tbt.ffn_block_train(h, dict(zip(tbt.FFN_PARAMS, ffn_p)), 3, 1e-12, 0.1)
    y.square().sum().backward()
    assert [fn.launches for fn in tbt.KERNEL_WRAPPERS] == [1, 1, 1, 1]
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in att_p + ffn_p)
    assert x.grad.shape == x.shape


def test_train_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    layer = _layer(16, 2).to(cuda_device)
    att_p, ffn_p = _train_params(layer)
    x = torch.randn((2, 8, 16), device=cuda_device)
    pf = tbt.pack_ffn(ffn_p, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        tbt.ffn_train_forward(x.half(), pf, 0)
    with pytest.raises(ValueError, match="w1: dtype"):
        tbt.ffn_train_forward(x, tbt.pack_ffn(ffn_p, torch.bfloat16), 0)
    with pytest.raises(ValueError, match="S <= 128"):
        tbt.attention_train_forward(
            torch.randn((1, 129, 16), device=cuda_device),
            tbt.pack_attention(att_p, torch.float32),
            torch.zeros((1, 129), device=cuda_device), 0, 2)


def test_train_backwards_give_the_same_bits_twice(cuda_device):
    """Two calls of each bf16 train backward are bitwise equal: no atomics,
    and the weight gradients' split-K partials are summed in a fixed order."""
    att_p, ffn_p = _train_params(_layer(256, 4).to(cuda_device))
    pa = tbt.pack_attention(att_p, torch.bfloat16)
    pf = tbt.pack_ffn(ffn_p, torch.bfloat16)
    gen = torch.Generator().manual_seed(3)
    b, s = 4, 128
    x, dy = (torch.randn((b, s, 256), generator=gen).to(cuda_device, torch.bfloat16)
             for _ in range(2))
    bias = torch.zeros((b, s), device=cuda_device)
    bias[1, 70:] = -10000.0
    z = tbt.ffn_train_forward(x, pf, 9, 1e-12, 0.1)[1]
    runs = {
        "attention": lambda: tbt.attention_train_backward(x, dy, pa, bias, 9, 4,
                                                          1e-12, 0.1, 0.1),
        "ffn": lambda: tbt.ffn_train_backward(x, z, dy, pf, 9, 1e-12, 0.1)}
    for name, run in runs.items():
        (dx1, g1), (dx2, g2) = run(), run()
        assert torch.equal(dx1, dx2), name
        for k in g1:
            assert torch.equal(g1[k], g2[k]), (name, k)


# The backward GEMM alone against a float32 product of the same bf16 inputs,
# relative to the largest |value|: a float32 weight gradient differs in the
# order of its sums only; a bf16 data gradient by one rounding (2^-8 of a
# value), allowed twice.
GEMM_REL = {True: 1e-4, False: 2.0 ** -7}


@pytest.mark.parametrize("transpose_a, shape_a, shape_b", [
    # data gradients a (M, K) . b (K, N): ragged M, N past a 256-wide tile
    # and K past a 64-deep one; K = 37 takes the mma.sync GEMM (TMA needs
    # row strides of a multiple of 8).
    (False, (148, 768), (768, 320)),
    (False, (300, 200), (200, 768)),
    (False, (148, 37), (37, 64)),
    # weight gradients a (K, M)^T . b (K, N) over K rows: ragged K (148, and
    # 4100 split along K into partials), M and N past their tiles.
    (True, (148, 768), (148, 256)),
    (True, (4100, 192), (4100, 320)),
    (True, (148, 37), (148, 16)),
], ids=["dY.W", "dY.W-ragged-K", "dY.W-mma.sync", "dW", "dW-split-K",
        "dW-mma.sync"])
def test_backward_gemm_layouts_match_a_float_product(cuda_device, transpose_a,
                                                      shape_a, shape_b):
    gen = torch.Generator().manual_seed(11)
    a = torch.randn(shape_a, generator=gen).to(cuda_device, torch.bfloat16)
    b = torch.randn(shape_b, generator=gen).to(cuda_device, torch.bfloat16)
    got = tbt.backward_gemm(a, b, transpose_a)
    want = (a.float().t() if transpose_a else a.float()) @ b.float()
    assert got.dtype == (torch.float32 if transpose_a else torch.bfloat16)
    assert got.shape == want.shape
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= GEMM_REL[transpose_a]


def _forward_operands(m, n, k, seed=13):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn((m, k), generator=gen)
    w = torch.randn((n, k), generator=gen) * k ** -0.5
    bias = torch.randn((n,), generator=gen) * 0.1
    resid = torch.randn((m, n), generator=gen)
    return a, w, bias, resid


@pytest.mark.parametrize("mode", tbt.FORWARD_MODES,
                         ids=lambda m: f"mode{m}")
@pytest.mark.parametrize("m, n, k", [
    (37, 200, 768),      # ragged M and N
    (32, 3072, 768),     # one sentence of bucket 32: the smallest serving M
    (1100, 200, 136),    # ragged M, N and K past their tiles
    (4096, 3072, 768),   # the W1 product at B=32, S=128
    (4096, 768, 3072),   # the W2 product at B=32, S=128
    (4000, 700, 1000),   # ragged; the residual epilogues on the 128 x 256 tile
    (4096, 2304, 768),   # the q/k/v product at B=32, S=128
    (32768, 2304, 768),  # the q/k/v product at B=256, S=128
    (4096, 768, 768),    # the out-projection at B=32, S=128
    (32768, 768, 768),   # the out-projection at B=256, S=128
], ids=["ragged", "M32", "ragged-K", "W1", "W2", "ragged-coop", "qkv", "qkv-train",
        "out", "out-train"])
def test_forward_gemm_matches_a_float_product(cuda_device, mode, m, n, k):
    """Each forward weight product (x·Wqkvᵀ with its bias, x·W1ᵀ with gelu,
    ctx·Woᵀ and inter·W2ᵀ into the f32 residual with and without the output
    dropout, the backward's t1 replay) on the blocks' route, K-major
    weights, against its plain version: outputs that pass through a bf16
    rounding within GEMM_REL's one-rounding limit, the unrounded float32
    ones within its summation-order limit."""
    a, w, bias, resid = (t.to(cuda_device) for t in _forward_operands(m, n, k))
    a, w, resid = (t.to(torch.bfloat16) for t in (a, w, resid))
    args = (a, w, bias, mode, resid, 77, 1 if m % 32 else 32, 0.1)
    got, want = tbt.forward_gemm(*args), tbt.forward_gemm_plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    unrounded = mode in (tbt.EPI_RESID_F32, tbt.EPI_RESID_F32_DROP)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and g.shape == w_.shape
        assert _rel_err(g, w_) <= GEMM_REL[unrounded], mode


@pytest.mark.parametrize("m", [4096, 32768])
def test_forward_gelu_equals_the_replay_bit_for_bit(cuda_device, m):
    """The FFN forward's gelu(t1) (the W1 product's epilogue) and the
    backward's replay of it are the same bits at the serving (B=32) and
    training (B=256) row counts: one route, one accumulation order, one
    gelu expression."""
    a, w, bias, _ = _forward_operands(m, 3072, 768, seed=m)
    a, w = (t.to(cuda_device, torch.bfloat16) for t in (a, w))
    bias = bias.to(cuda_device)
    inter = tbt.forward_gemm(a, w, bias, tbt.EPI_BIAS_GELU)
    t1, replay = tbt.forward_gemm(a, w, bias, tbt.EPI_BIAS_T1_GELU)
    torch.cuda.synchronize()
    assert torch.equal(inter, replay)
    assert _rel_err(t1, tbt.dense(a, w, bias)) <= GEMM_REL[False]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("s", [37, 64, 128])
def test_attention_core_matches_plain(cuda_device, dtype, rate, s):
    """The attention core alone (bf16 at head_dim 64: the persistent
    tensor-core core; float32: the CUDA-core one) against its plain version,
    padded rows and the probability dropout included, 40 (example, head)
    pairs: more than one per block where the blocks are fewer."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(s)
    b, heads = 10, 4
    qkv = torch.randn((b, s, 3 * 64 * heads), generator=gen).to(cuda_device, dt)
    mask = torch.ones((b, s), dtype=torch.long, device=cuda_device)
    mask[1, s // 2:] = 0
    mask[7, 3:] = 0
    bias = tbert.attention_bias_from_mask(mask, dt).reshape(b, s).float()
    got = tbt.attention_core(qkv, bias, 99 + s, heads, rate)
    want = tbt.attention_core_plain(qkv, bias, 99 + s, heads, rate)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _rel_err(got, want) <= TRAIN_REL[dtype]


@pytest.mark.parametrize("m", [4096, 32768])
def test_attention_forward_equals_the_replay_bit_for_bit(cuda_device, m):
    """The attention train forward's q/k/v, ctx and pre-LN z32 and the
    backward's recompute of them are the same bits at the serving (B=32) and
    training (B=256) row counts, dropout 0.1 on both sites: one route per
    product, one core launcher, one accumulation order."""
    att_p, _ = _train_params(_layer(768, 12).to(cuda_device))
    pa = tbt.pack_attention(att_p, torch.bfloat16)
    gen = torch.Generator().manual_seed(m)
    b = m // 128
    x, dy = (torch.randn((b, 128, 768), generator=gen).to(cuda_device, torch.bfloat16)
             for _ in range(2))
    bias = torch.zeros((b, 128), device=cuda_device)
    bias[1, 90:] = -10000.0
    fwd, bwd = {}, {}
    tbt.attention_train_forward(x, pa, bias, 17, 12, 1e-12, 0.1, 0.1, scratch=fwd)
    tbt.attention_train_backward(x, dy, pa, bias, 17, 12, 1e-12, 0.1, 0.1, scratch=bwd)
    torch.cuda.synchronize()
    for k in ("qkv", "ctx", "z32"):
        assert torch.equal(fwd[k], bwd[k]), k


@pytest.mark.parametrize("preset,layers", [("bert-pho2-res-arch3", 19),
                                           ("bert", 12)])
def test_train_step_spans_each_encoder_backward(cuda_device, monkeypatch,
                                                preset, layers):
    """A bf16 kernel step of the Trainer at the presets' layer counts
    records one 'encoder.attn_bwd' and one 'encoder.ffn_bwd' span per
    encoder layer (arch3 12 + 4 + 3, bert 12), on the autograd engine's
    thread, each with device time; its gradients and weights are those of
    the same step without spans, bit for bit. cuDNN's float32 weight
    gradients of the glyph convolutions differ from call to call (see
    test_pretraining_kernel_path_matches_plain_path), so both steps take
    its deterministic algorithms."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = config_for(preset, vocab_size=300, hidden_size=128,
                     num_attention_heads=2, intermediate_size=256,
                     num_fonts=1, dtype="bfloat16")
    rng = np.random.RandomState(4)
    b, s = 4, 37
    masks = np.ones((b, s), np.int64)
    masks[1, 20:] = 0
    batch = {"src_idx": rng.randint(0, cfg.vocab_size, (b, s)),
             "tgt_idx": rng.randint(0, cfg.vocab_size, (b, s)),
             "masks": masks, "loss_masks": masks.copy(),
             "pho_idx": rng.randint(1, 30, (b, s, cfg.pho2_max_len)),
             "pho_lens": rng.randint(0, cfg.pho2_max_len + 1, (b, s))}

    def trainer():
        gen = torch.Generator().manual_seed(0)
        model = Realise(cfg, generator=gen)
        if cfg.with_res:
            model.install_glyphs((torch.rand(
                model.char_images_multifonts.shape, generator=gen) < 0.5
            ).float())
        return Trainer(cfg, model, use_kernels=True, device=cuda_device,
                       seed=5)

    plain, traced = trainer(), trainer()
    rec = SpanRecorder(cuda_device)
    traced.model.span = rec.span
    plain.train_step(batch)
    traced.train_step(batch)
    totals = rec.totals()
    for name in ("encoder.attn_bwd", "encoder.ffn_bwd"):
        assert totals[name]["count"] == layers, name
        assert totals[name]["device_ms"] > 0, name
    for (name, p), q in zip(plain.model.named_parameters(),
                            traced.model.parameters()):
        assert torch.equal(p.grad, q.grad), name
        assert torch.equal(p, q), name


# ------------------------------------------------------- the update kernels
def _update_model(device):
    """A small arch3 on the card: both decay groups, 2-D weights, biases and
    LayerNorms, tensors of every size up to the vocabulary's."""
    return Realise(_tiny_cfg("float32"),
                   generator=torch.Generator().manual_seed(0)).to(device)


def _step_sums(params, seed, unused=()):
    """Gradient sums of one step (over ~37 tokens), zero for the unused
    parameters, made on the CPU and moved to the card."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.zeros(p.shape) if i in unused
            else torch.randn(p.shape, generator=gen) * 40
            for i, p in enumerate(params)]


def _plain_step(opt, params, sums, count, max_norm):
    """The trainer's CPU path on the card: divide, clip, torch's AdamW."""
    for p, s in zip(params, sums):
        p.grad = s.to(p.device, copy=True).div_(torch.clamp(count, min=1.0))
    norm = (toptim.clip_by_global_norm([p.grad for p in params], max_norm)
            if max_norm is not None else None)
    opt.step()
    return norm


def _kernel_step(opt, params, sums, count, max_norm):
    for p, s in zip(params, sums):
        p.grad = s.to(p.device)
    norm = opt.clip(count, max_norm)
    opt.step()
    return norm


def _plain_adamw(kernel_opt):
    """torch.optim.AdamW over the groups of ``kernel_opt``'s twin."""
    return torch.optim.AdamW([dict(g, params=list(g["params"]))
                              for g in kernel_opt.param_groups])


def _assert_update_close(kernel_params, kernel_opt, plain_params, plain_opt):
    """Parameters and both moments within 1e-6 of each tensor's largest
    value: the two differ in the order of the norm's sums and in FMA
    contraction only."""
    for p, q in zip(kernel_params, plain_params):
        assert _rel_err(p, q) <= 1e-6
        for k in ("exp_avg", "exp_avg_sq"):
            assert _rel_err(kernel_opt.state[p][k], plain_opt.state[q][k]) \
                <= 1e-6, k


@pytest.mark.parametrize("max_norm", [1e-2, 1e6, None])
def test_update_kernels_match_the_plain_path(cuda_device, max_norm):
    """Four steps of the kernel path and of the plain path from one small
    arch3, both decay groups, one parameter unused (zero gradient sums),
    the clip engaged (1e-2), not engaged (1e6) and off (None): parameters
    and moments agree (_assert_update_close), and the norms within 1e-6;
    a second kernel run gives the same bits; the gradients stay the sums;
    each step is two launches (one without the clip)."""
    from realise_tpu_torch.ops.kernels import adamw as kadamw

    model = _update_model(cuda_device)
    copies = [copy.deepcopy(model) for _ in range(3)]
    opts = [toptim.make_optimizer(m, 2e-3, 0.01) for m in copies]
    params = [[p for g in o.param_groups for p in g["params"]] for o in opts]
    plain = _plain_adamw(opts[2])
    unused = {len(params[0]) - 1}
    count = torch.tensor(37.0, device=cuda_device)
    launches = (kadamw.global_norm_partials.launches,
                kadamw.adamw_update.launches)
    for step in range(4):
        sums = _step_sums(params[0], step, unused)
        norms = [_kernel_step(o, ps, sums, count, max_norm)
                 for o, ps in zip(opts[:2], params[:2])]
        want = _plain_step(plain, params[2], sums, count, max_norm)
        if max_norm is not None:
            assert abs(norms[0].item() - want.item()) <= 1e-6 * want.item()
            assert (want.item() >= max_norm) == (max_norm < 1)
            assert torch.equal(norms[0], norms[1])
        for p, s in zip(params[0], sums):
            assert torch.equal(p.grad, s.to(cuda_device))
    assert (kadamw.global_norm_partials.launches - launches[0],
            kadamw.adamw_update.launches - launches[1]) == (
        (0 if max_norm is None else 8), 8)
    assert kadamw.adamw_update.tensors == len(params[0])
    assert kadamw.adamw_update.elements == sum(p.numel() for p in params[0])
    _assert_update_close(params[0], opts[0], params[2], plain)
    for p, q in zip(params[0], params[1]):
        assert torch.equal(p, q)
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opts[0].state[p][k], opts[1].state[q][k])
    assert torch.count_nonzero(opts[0].state[params[0][-1]]["exp_avg"]) == 0


def _side(model, kernel):
    """A copy of ``model`` with make_optimizer's groups, on the kernel path
    or torch's AdamW: (model, optimizer, parameters in group order,
    kernel)."""
    m = copy.deepcopy(model)
    opt = toptim.make_optimizer(m, 2e-3, 0.01)
    if not kernel:
        opt = _plain_adamw(opt)
    return m, opt, [p for g in opt.param_groups for p in g["params"]], kernel


def _run(side, sums, count):
    _, opt, params, kernel = side
    (_kernel_step if kernel else _plain_step)(opt, params, sums, count, 1e-2)


def test_update_kernels_load_torch_state_dicts(cuda_device):
    """Two steps on each path, then each state dict into fresh optimizers of
    both paths over the saver's weights: torch's format on both (step 2 in
    every parameter's state, the same keys and groups), and the third step
    of a loaded optimizer gives the bits its own path gives from that
    state (the saver's third step) or, on the other path, agrees with it
    within _assert_update_close's limit."""
    count = torch.tensor(37.0, device=cuda_device)
    model = _update_model(cuda_device)
    own = {True: _side(model, True), False: _side(model, False)}
    sums = [_step_sums(own[True][2], 10 + k) for k in range(3)]
    for k in range(2):
        for side in own.values():
            _run(side, sums[k], count)
    saved = {k: copy.deepcopy(side[1].state_dict())
             for k, side in own.items()}
    for st in saved.values():
        assert {float(s["step"]) for s in st["state"].values()} == {2.0}
    assert saved[True]["param_groups"] == saved[False]["param_groups"]
    assert [list(s) for s in saved[True]["state"].values()] == [
        list(s) for s in saved[False]["state"].values()]
    loaded = {}
    for saver in (True, False):
        for kernel in (True, False):
            side = loaded[saver, kernel] = _side(own[saver][0], kernel)
            side[1].load_state_dict(copy.deepcopy(saved[saver]))
    for side in list(own.values()) + list(loaded.values()):
        _run(side, sums[2], count)
    for (saver, kernel), side in loaded.items():
        mine = own[saver]
        if kernel == saver:
            for p, q in zip(side[2], mine[2]):
                assert torch.equal(p, q), (saver, kernel)
                for k in ("exp_avg", "exp_avg_sq"):
                    assert torch.equal(side[1].state[p][k],
                                       mine[1].state[q][k]), (saver, k)
        else:
            k_side, p_side = (side, mine) if kernel else (mine, side)
            _assert_update_close(k_side[2], k_side[1], p_side[2], p_side[1])
        assert {float(s["step"]) for s in
                side[1].state_dict()["state"].values()} == {3.0}


def test_update_kernels_refuse_what_they_do_not_take(cuda_device):
    """A non-contiguous or bfloat16 parameter, parameters on the CPU and
    the card together, a non-contiguous gradient, a missing one, a step
    that no clip() declared."""
    dev = cuda_device
    count = torch.ones((), device=dev)

    def step(*params):
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt = toptim.AdamW(list(params))
        opt.clip(count, None)
        opt.step()

    with pytest.raises(ValueError, match="contiguous"):
        step(torch.nn.Parameter(torch.randn(6, 4, device=dev).t()))
    with pytest.raises(ValueError, match="dtype"):
        step(torch.nn.Parameter(torch.randn(8, device=dev,
                                            dtype=torch.bfloat16)))
    with pytest.raises(ValueError, match="one CUDA device"):
        step(torch.nn.Parameter(torch.randn(8)),
             torch.nn.Parameter(torch.randn(8, device=dev)))
    p = torch.nn.Parameter(torch.randn(4, 6, device=dev))
    p.grad = torch.randn(6, 4, device=dev).t()
    with pytest.raises(ValueError, match="contiguous"):
        step(p)
    q = torch.nn.Parameter(torch.randn(4, device=dev))
    opt = toptim.AdamW([q])
    opt.clip(count, None)
    with pytest.raises(ValueError, match="no gradient"):
        opt.step()
    q.grad = torch.zeros_like(q)
    opt = toptim.AdamW([q])
    with pytest.raises(ValueError, match="follows clip"):
        opt.step()


def test_update_kernels_over_many_unaligned_tensors(cuda_device):
    """1000 tensors of 1 to 3000 elements, views at odd offsets of one
    buffer (the kernels' scalar route), two groups: three launches of each
    kernel a step (448 gradients a launch), and the plain path's result
    within _assert_update_close's limit."""
    from realise_tpu_torch.ops.kernels import adamw as kadamw

    rng = np.random.RandomState(3)
    sizes = rng.randint(1, 3001, 1000)
    buf = torch.randn(int(sizes.sum()) + len(sizes), device=cuda_device)
    offsets = np.cumsum(np.concatenate([[1], sizes[:-1] + 1]))
    views = [torch.nn.Parameter(buf[o:o + n]) for o, n in zip(offsets, sizes)]
    copies = [torch.nn.Parameter(v.detach().clone()) for v in views]
    assert sum(v.data_ptr() % 16 != 0 for v in views) > 500

    def groups(ps):
        return [{"params": ps[::2], "weight_decay": 0.1},
                {"params": ps[1::2], "weight_decay": 0.0}]

    kern = toptim.AdamW(groups(views), lr=2e-3)
    plain = torch.optim.AdamW(groups(copies), lr=2e-3)
    order = [p for g in kern.param_groups for p in g["params"]]
    plain_order = [p for g in plain.param_groups for p in g["params"]]
    count = torch.tensor(11.0, device=cuda_device)
    launches = kadamw.adamw_update.launches
    for step in range(2):
        sums = _step_sums(order, 20 + step)
        _kernel_step(kern, order, sums, count, 1e-2)
        _plain_step(plain, plain_order, sums, count, 1e-2)
    assert kadamw.adamw_update.launches - launches == 6
    _assert_update_close(order, kern, plain_order, plain)


def test_trainer_updates_in_two_launches_a_step(cuda_device):
    """The Trainer on the card (kernel path, float32): two update launches
    a step, and the 'clip+adamw' span holds device time."""
    from realise_tpu_torch.ops.kernels import adamw as kadamw

    cfg = _tiny_cfg("float32")
    gen = torch.Generator().manual_seed(0)
    model = Realise(cfg, generator=gen)
    model.install_glyphs((torch.rand(model.char_images_multifonts.shape,
                                     generator=gen) < 0.5).float())
    tr = Trainer(cfg, model, use_kernels=True, device=cuda_device)
    rec = SpanRecorder(cuda_device)
    tr.model.span = rec.span
    rng = np.random.RandomState(6)
    b, s = 4, 20
    masks = np.ones((b, s), np.int64)
    batch = {"src_idx": rng.randint(0, cfg.vocab_size, (b, s)),
             "tgt_idx": rng.randint(0, cfg.vocab_size, (b, s)),
             "masks": masks, "loss_masks": masks.copy(),
             "pho_idx": rng.randint(1, 30, (b, s, cfg.pho2_max_len)),
             "pho_lens": rng.randint(0, cfg.pho2_max_len + 1, (b, s))}
    def launches():
        return (kadamw.global_norm_partials.launches
                + kadamw.adamw_update.launches)

    before = launches()
    for _ in range(3):
        tr.train_step(batch)
    assert launches() - before == 6
    assert rec.totals()["clip+adamw"]["device_ms"] > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_after_a_train_step_reads_the_new_weights(cuda_device, dtype):
    """The update kernel writes through raw pointers, and AdamW.step bumps
    the versions it wrote: every parameter's ``_version`` rises in a train
    step, so the block kernels' cached packs (``BertLayer.kernel_params``)
    follow the update. eval_step → train_step → eval_step gives the logits,
    bit for bit, of a fresh Trainer loaded with the trained state dict."""
    cfg = _tiny_cfg(dtype)

    def trainer():
        gen = torch.Generator().manual_seed(0)
        model = Realise(cfg, generator=gen)
        model.install_glyphs((torch.rand(model.char_images_multifonts.shape,
                                         generator=gen) < 0.5).float())
        return Trainer(cfg, model, learning_rate=1e-3, use_kernels=True,
                       device=cuda_device)

    def eval_logits(tr):
        seen = []
        hook = tr.model.register_forward_hook(
            lambda module, args, out: seen.append(out["logits"].clone()))
        try:
            tr.eval_step(batch)
        finally:
            hook.remove()
        return seen[0]

    rng = np.random.RandomState(8)
    b, s = 4, 20
    masks = np.ones((b, s), np.int64)
    masks[1, 13:] = 0
    batch = {"src_idx": rng.randint(0, cfg.vocab_size, (b, s)),
             "tgt_idx": rng.randint(0, cfg.vocab_size, (b, s)),
             "masks": masks, "loss_masks": masks.copy(),
             "pho_idx": rng.randint(1, 30, (b, s, cfg.pho2_max_len)),
             "pho_lens": rng.randint(0, cfg.pho2_max_len + 1, (b, s))}
    tr = trainer()
    first = eval_logits(tr)
    params = list(tr.model.parameters())
    before = [p._version for p in params]
    tr.train_step(batch)
    assert all(p._version > v for p, v in zip(params, before))
    got = eval_logits(tr)
    fresh = trainer()
    fresh.model.load_state_dict(tr.model_state_dict())
    want = eval_logits(fresh)
    assert not torch.equal(first, want)
    assert torch.equal(got, want)


# ------------------------------------------------------- the masked CE kernels
def _ce_inputs(device, dtype, rows, v, with_bias, seed=0):
    """Logits of spread ~3 (a few rows much wider), a bias, labels with
    rows at columns 0 and V-1, a mask with a quarter of the rows 0."""
    gen = torch.Generator().manual_seed(seed)
    logits = torch.randn((rows, v), generator=gen) * 3
    logits[::7] *= 8
    labels = torch.randint(0, v, (rows,), generator=gen)
    labels[:3] = 0
    labels[3:6] = v - 1
    mask = (torch.rand(rows, generator=gen) > 0.25).long()
    mask[0] = mask[3] = 0
    bias = torch.randn(v, generator=gen) if with_bias else None
    dt = getattr(torch, dtype)
    return (logits.to(device, dt), None if bias is None else bias.to(device),
            labels.to(device), mask.to(device))


def _ulp_err(got, want):
    """Largest |got - want| over ulps of the larger of the two in bf16
    (2^-7 of it at most) or float32 (2^-23)."""
    eps = 2.0 ** -7 if want.dtype == torch.bfloat16 else 2.0 ** -23
    g, w = got.float(), want.float()
    scale = torch.maximum(g.abs(), w.abs()) * eps
    diff = (g - w).abs()
    return (diff / scale.clamp_min(1e-38)).masked_fill(diff == 0, 0).max().item()


@pytest.mark.parametrize("v", [21128, 7607, 65537])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_ce_kernels_match_plain(cuda_device, dtype, with_bias, v):
    """The loss through ``masked_cross_entropy_sum`` (the kernels) against
    the plain versions on the card, at the vocabulary's V (the 16-byte
    route) and at ragged ones (the scalar route; 7607 and 65537 are odd),
    301 rows (a ragged last chunk and group of rows): the gold logits the
    same bits, logz and the loss sum within float32 summation order,
    dlogits within one ulp of the plain backward from the same logz, masked
    rows zero, and dbias the column sum of the kernel's own dlogits within
    float32 summation order."""
    from realise_tpu_torch.models.realise import masked_cross_entropy_sum
    from realise_tpu_torch.ops.kernels import masked_ce as kce

    rows = 301
    logits, bias, labels, mask = _ce_inputs(cuda_device, dtype, rows, v,
                                            with_bias)
    logz, gold = kce.masked_ce_fwd(logits, bias, labels)
    want_logz, want_gold = kce.masked_ce_fwd_plain(logits, bias, labels)
    assert torch.equal(gold, want_gold)
    assert _rel_err(logz, want_logz) <= 2e-6

    x = logits.clone().requires_grad_(True)
    b = None if bias is None else bias.clone().requires_grad_(True)
    loss, count = masked_cross_entropy_sum(x[None], labels[None], mask[None], b)
    (0.37 * loss).backward()
    m = mask.float()
    want_loss = ((want_logz - want_gold) * m).sum()
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    assert count.item() == m.sum().item()
    dsum = torch.tensor(0.37, device=cuda_device)
    want_dl, want_db = kce.masked_ce_bwd_plain(logits, bias, labels, m, logz,
                                               dsum)
    assert x.grad.dtype == logits.dtype
    assert _ulp_err(x.grad, want_dl) <= 1.0
    assert torch.count_nonzero(x.grad[mask == 0]) == 0
    if with_bias:
        own = x.grad.float().sum(0)
        assert _rel_err(b.grad, own) <= 1e-5
        assert _rel_err(b.grad, want_db) <= 2.0 ** -8
    else:
        assert want_db is None


def test_masked_ce_kernels_give_the_same_bits_twice(cuda_device):
    """Two calls of both kernels at 4096 rows of the vocabulary's V in bf16
    with a bias: logz, gold, dlogits and dbias the same bits."""
    from realise_tpu_torch.ops.kernels import masked_ce as kce

    logits, bias, labels, mask = _ce_inputs(cuda_device, "bfloat16", 4096,
                                            21128, True, seed=1)
    m = mask.float()
    dsum = torch.ones((), device=cuda_device)
    runs = []
    for _ in range(2):
        logz, gold = kce.masked_ce_fwd(logits, bias, labels)
        runs.append((logz, gold) + kce.masked_ce_bwd(logits, bias, labels, m,
                                                     logz, dsum))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_masked_ce_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """float16 or 3-D or non-contiguous logits, a bfloat16 or misshapen
    bias, int32 labels or labels on the CPU, a float64 mask in the
    backward; a label out of range reads a NaN gold logit."""
    from realise_tpu_torch.ops.kernels import masked_ce as kce

    dev = cuda_device
    logits, bias, labels, mask = _ce_inputs(dev, "bfloat16", 8, 64, True)
    m = mask.float()
    with pytest.raises(ValueError, match="dtype"):
        kce.masked_ce_fwd(logits.half(), bias, labels)
    with pytest.raises(ValueError, match="3-D"):
        kce.masked_ce_fwd(logits[None], bias, labels)
    with pytest.raises(ValueError, match="contiguous"):
        kce.masked_ce_fwd(torch.zeros((64, 8), device=dev,
                                      dtype=torch.bfloat16).t(), bias, labels)
    with pytest.raises(ValueError, match="dtype"):
        kce.masked_ce_fwd(logits, bias.bfloat16(), labels)
    with pytest.raises(ValueError, match="shape"):
        kce.masked_ce_fwd(logits, bias[:63], labels)
    with pytest.raises(ValueError, match="dtype"):
        kce.masked_ce_fwd(logits, bias, labels.int())
    with pytest.raises(ValueError, match="on cpu"):
        kce.masked_ce_fwd(logits, bias, labels.cpu())
    logz, _ = kce.masked_ce_fwd(logits, bias, labels)
    with pytest.raises(ValueError, match="dtype"):
        kce.masked_ce_bwd(logits, bias, labels, m.double(), logz,
                          torch.ones((), device=dev))
    bad = labels.clone()
    bad[2] = 64
    logz, gold = kce.masked_ce_fwd(logits, bias, bad)
    assert torch.isnan(gold[2]) and not torch.isnan(gold[[0, 1, 3]]).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_launches_each_ce_kernel_once(cuda_device, dtype):
    """The Trainer on the card: each step calls the CE forward and backward
    once each, and 'head+ce.bwd' holds device time once a step."""
    from realise_tpu_torch.ops.kernels import masked_ce as kce

    cfg = _tiny_cfg(dtype)
    gen = torch.Generator().manual_seed(0)
    model = Realise(cfg, generator=gen)
    model.install_glyphs((torch.rand(model.char_images_multifonts.shape,
                                     generator=gen) < 0.5).float())
    tr = Trainer(cfg, model, use_kernels=True, device=cuda_device)
    rec = SpanRecorder(cuda_device)
    tr.model.span = rec.span
    rng = np.random.RandomState(7)
    b, s = 4, 20
    masks = np.ones((b, s), np.int64)
    masks[2, 12:] = 0
    batch = {"src_idx": rng.randint(0, cfg.vocab_size, (b, s)),
             "tgt_idx": rng.randint(0, cfg.vocab_size, (b, s)),
             "masks": masks, "loss_masks": masks.copy(),
             "pho_idx": rng.randint(1, 30, (b, s, cfg.pho2_max_len)),
             "pho_lens": rng.randint(0, cfg.pho2_max_len + 1, (b, s))}
    before = (kce.masked_ce_fwd.launches, kce.masked_ce_bwd.launches)
    for _ in range(3):
        loss = tr.train_step(batch)
    assert np.isfinite(float(loss))
    assert (kce.masked_ce_fwd.launches - before[0],
            kce.masked_ce_bwd.launches - before[1]) == (3, 3)
    spans = rec.totals()
    assert spans["head+ce.bwd"]["count"] == 3
    assert spans["head+ce.bwd"]["device_ms"] > 0


# ------------------------------------------------------ the BatchNorm kernels
# Each BatchNorm's (C, H*W) in the ``resnet`` CharResNet at H 768 (blocks 1-5)
# and in ``resnet1`` (its blocks 3 and 4; 1 and 2 are resnet's).
BN_SHAPES = [(64, 256), (128, 64), (256, 16), (512, 4), (768, 1), (192, 16),
             (192, 4)]


def _f32_ulps(got, want):
    """Largest |got - want| in float32 ulps of the larger of the two."""
    g, w = got.double(), want.double()
    big = torch.maximum(g.abs(), w.abs()).float()
    ulp = (torch.nextafter(big, torch.full_like(big, float("inf"))) - big)
    diff = (g - w).abs()
    return (diff / ulp.double()).masked_fill(diff == 0, 0).max().item()


def _bn_module(c, seed, device):
    gen = torch.Generator().manual_seed(seed)
    bn = torch.nn.BatchNorm2d(c, eps=1e-5).train()
    with torch.no_grad():
        bn.weight.normal_(1.0, 0.2, generator=gen)
        bn.bias.normal_(0.0, 0.2, generator=gen)
        bn.running_mean.normal_(0.0, 0.2, generator=gen)
        bn.running_var.uniform_(0.5, 1.5, generator=gen)
    return bn.to(device)


def _bn_inputs(device, dtype, rows, c, hw, weighted, seed):
    """x (rows, C, H, W) of spread ~2 around 1, channel 0 around 50 times
    its spread (what a ReLU and many rows of one glyph give); counts with
    zeros (the pad rows of a row bucket); the output's gradient."""
    gen = torch.Generator().manual_seed(seed)
    side = int(hw ** 0.5)
    x = torch.randn((rows, c, side, side), generator=gen) * 2 + 1
    x[:, 0] = 50 + torch.randn((rows, side, side), generator=gen)
    w = None
    if weighted:
        w = torch.randint(0, 6, (rows,), generator=gen).float()
        w[-1] = 0
        w[0] = 3
    dy = torch.randn((rows, c, side, side), generator=gen)
    dt = getattr(torch, dtype)
    return (x.to(device, dt), None if w is None else w.to(device),
            dy.to(device, dt))


def _plain_stats(x, w):
    """batch_norm_train's float32 mean and var of x."""
    x64 = x.double()
    if w is None:
        return (x64.mean(dim=(0, 2, 3)).float(),
                x64.var(dim=(0, 2, 3), unbiased=False).float())
    w64 = w.double()
    n = torch.clamp(w64.sum() * (x.shape[2] * x.shape[3]), min=1.0)
    mean = torch.einsum("nchw,n->c", x64, w64) / n
    var = torch.clamp(torch.einsum("nchw,n->c", x64 * x64, w64) / n
                      - mean * mean, min=0.0)
    return mean.float(), var.float()


def _bn_run(fn, bns, xs, w, dy):
    """fn's output, x and parameter gradients and running statistics."""
    xs = [x.clone().requires_grad_(True) for x in xs]
    for bn in bns:
        bn.zero_grad(set_to_none=True)
    y = fn(*xs)
    y.backward(dy)
    out = [y] + [x.grad for x in xs]
    for bn in bns:
        out += [bn.weight.grad, bn.bias.grad, bn.running_mean.clone(),
                bn.running_var.clone(), bn.num_batches_tracked.clone()]
    return out


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 37, 2816])
@pytest.mark.parametrize("c, hw", BN_SHAPES)
def test_batch_norm_kernels_match_plain(cuda_device, c, hw, rows, dtype,
                                        weighted):
    """relu(bn(x)) and a block's tail relu(bn(x) + bn2(x2)) through the
    kernels against the eager chain of ops/resnet.py on the card, at each
    BatchNorm's (C, H*W) of both CharResNets and 1, 37 and 2816 rows, with
    row weights (zeros among them) and without. Statistics within 2
    float32 ulps (both in float64, rounded: only the order of the sums
    differs), inv and shift the plain formulas' bits from them; the running
    statistics within 2 ulps; outputs within one ulp of their dtype (the
    same rounding points: a flip where the statistics' last bit moved);
    dx and the parameter gradients, float32, within 1e-5 of each tensor's
    largest value (float32 sums in other orders); bf16 dx within one bf16
    ulp of its largest value (where the ReLU masks dy, dx is the small
    correction w/T * (sum(g) + xhat * sum(g*xhat)) alone, whose sums'
    order can move its rounding by several of its own ulps)."""
    from realise_tpu_torch.ops.kernels import batch_norm as kbn

    x, w, dy = _bn_inputs(cuda_device, dtype, rows, c, hw, weighted, rows + c)
    x2, _, _ = _bn_inputs(cuda_device, dtype, rows, c, hw, False, rows + c + 1)
    for tail in (False, True):
        bns_k = [_bn_module(c, 3 + j, cuda_device) for j in range(1 + tail)]
        bns_p = [copy.deepcopy(bn) for bn in bns_k]
        xs = (x, x2) if tail else (x,)

        def kernel(*xs):
            if tail:
                return kbn.batch_norm_add_relu(bns_k[0], xs[0], bns_k[1],
                                               xs[1], w)
            return kbn.batch_norm_relu(bns_k[0], xs[0], w)

        def plain(*xs):
            if tail:
                return kbn.batch_norm_add_relu_plain(bns_p[0], xs[0],
                                                     bns_p[1], xs[1], w)
            return kbn.batch_norm_relu_plain(bns_p[0], xs[0], w)

        before = (kbn.bn_train_fwd.launches, kbn.bn_train_bwd.launches)
        got = _bn_run(kernel, bns_k, xs, w, dy)
        assert (kbn.bn_train_fwd.launches - before[0],
                kbn.bn_train_bwd.launches - before[1]) == (len(xs),) * 2
        want = _bn_run(plain, bns_p, xs, w, dy)

        # The statistics and the apply's coefficients.
        for j, xj in enumerate(xs):
            bn = _bn_module(c, 3 + j, cuda_device)
            _, coefs = kbn.bn_train_fwd((xj,), (bn,), w)
            cf = coefs[0].view(torch.float32)
            mean, var, inv, shift = cf[:c], cf[c:2 * c], cf[2 * c:3 * c], \
                cf[3 * c:4 * c]
            want_mean, want_var = _plain_stats(xj, w)
            assert _f32_ulps(mean, want_mean) <= 2
            assert _f32_ulps(var, want_var) <= 2
            want_inv = torch.rsqrt(var + 1e-5) * bn.weight
            assert torch.equal(inv, want_inv)
            assert torch.equal(shift, bn.bias - mean * want_inv)

        y, dxs = got[0], got[1:1 + len(xs)]
        assert y.dtype == x.dtype
        assert _ulp_err(y, want[0]) <= 1.0
        for a, b in zip(dxs, want[1:1 + len(xs)]):
            assert a.dtype == x.dtype
            if dtype == "bfloat16":
                assert _rel_err(a, b) <= 2.0 ** -7
            else:
                assert _rel_err(a, b) <= 1e-5
        per_bn = got[1 + len(xs):]
        for j in range(len(xs)):
            dg, db, rm, rv, nbt = per_bn[5 * j:5 * j + 5]
            wdg, wdb, wrm, wrv, wnbt = want[1 + len(xs) + 5 * j:][:5]
            assert _rel_err(dg, wdg) <= 1e-5
            assert _rel_err(db, wdb) <= 1e-5
            assert _f32_ulps(rm, wrm) <= 2
            assert _f32_ulps(rv, wrv) <= 2
            assert int(nbt) == int(wnbt) == 1


def test_batch_norm_kernels_give_the_same_bits_twice(cuda_device):
    """Two calls of the forward and backward at block 1's shape, 2816
    weighted rows in bf16, a tail: the output, the statistics and every
    gradient the same bits."""
    from realise_tpu_torch.ops.kernels import batch_norm as kbn

    x, w, dy = _bn_inputs(cuda_device, "bfloat16", 2816, 64, 256, True, 5)
    x2, _, _ = _bn_inputs(cuda_device, "bfloat16", 2816, 64, 256, False, 6)
    runs = []
    for _ in range(2):
        bns = [_bn_module(64, 3 + j, cuda_device) for j in range(2)]
        y, coefs = kbn.bn_train_fwd((x, x2), bns, w)
        runs.append([y, *coefs, *(bn.running_mean for bn in bns),
                     *(bn.running_var for bn in bns)]
                    + [t for ts in kbn.bn_train_bwd(
                        dy, (x, x2), [bn.weight for bn in bns], coefs, w)
                       for t in ts])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_batch_norm_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """float16, 3-D or non-contiguous x, x2 of another shape, float64 or
    misshapen row weights, weights on the CPU, a float64 BatchNorm, no
    rows."""
    from realise_tpu_torch.ops.kernels import batch_norm as kbn

    dev = cuda_device
    x, w, _ = _bn_inputs(dev, "bfloat16", 6, 8, 16, True, 0)
    bn = _bn_module(8, 0, dev)
    with pytest.raises(ValueError, match="dtype"):
        kbn.bn_train_fwd((x.half(),), (bn,), w)
    with pytest.raises(ValueError, match="3-D"):
        kbn.bn_train_fwd((x[0],), (bn,), w)
    with pytest.raises(ValueError, match="contiguous"):
        kbn.bn_train_fwd((x.transpose(2, 3),), (bn,), w)
    with pytest.raises(ValueError, match="shape"):
        kbn.bn_train_fwd((x, x[:3]), (bn, _bn_module(8, 1, dev)), w)
    with pytest.raises(ValueError, match="dtype"):
        kbn.bn_train_fwd((x,), (bn,), w.double())
    with pytest.raises(ValueError, match="shape"):
        kbn.bn_train_fwd((x,), (bn,), w[:5])
    with pytest.raises(ValueError, match="on cpu"):
        kbn.bn_train_fwd((x,), (bn,), w.cpu())
    with pytest.raises(ValueError, match="dtype"):
        kbn.bn_train_fwd((x,), (_bn_module(8, 0, dev).double(),), w)
    with pytest.raises(ValueError, match="no rows"):
        kbn.bn_train_fwd((x[:0],), (bn,), None)


def test_trainer_step_batch_norm_kernels_match_plain(cuda_device):
    """One float32 step of a tiny arch3 Trainer at dropout 0, kernels on
    against kernels off (the eager BatchNorm and encoder): the loss and
    every gradient within chip_smoke.py phase 8's limits (1e-5 and 1.5e-3
    of the larger of each tensor's largest value and 1e-4 of all
    gradients'), the running statistics within 1e-5; 15 BatchNorms a step
    through each kernel with them on, none off."""
    from realise_tpu_torch.ops.kernels import batch_norm as kbn

    cfg = _tiny_cfg("float32").replace(hidden_dropout_prob=0.0,
                                       attention_probs_dropout_prob=0.0)
    gen = torch.Generator().manual_seed(0)
    model = Realise(cfg, generator=gen)
    model.install_glyphs((torch.rand(model.char_images_multifonts.shape,
                                     generator=gen) < 0.5).float())
    rng = np.random.RandomState(9)
    b, s = 6, 24
    masks = np.ones((b, s), np.int64)
    masks[3, 15:] = 0
    batch = {"src_idx": rng.randint(0, cfg.vocab_size, (b, s)),
             "tgt_idx": rng.randint(0, cfg.vocab_size, (b, s)),
             "masks": masks, "loss_masks": masks.copy(),
             "pho_idx": rng.randint(1, 30, (b, s, cfg.pho2_max_len)),
             "pho_lens": rng.randint(0, cfg.pho2_max_len + 1, (b, s))}
    results = []
    for use_kernels in (True, False):
        tr = Trainer(cfg, copy.deepcopy(model), use_kernels=use_kernels,
                     device=cuda_device)
        before = (kbn.bn_train_fwd.launches, kbn.bn_train_bwd.launches)
        loss = float(tr.train_step(batch))
        launches = (kbn.bn_train_fwd.launches - before[0],
                    kbn.bn_train_bwd.launches - before[1])
        assert launches == ((15, 15) if use_kernels else (0, 0))
        results.append((loss, {n: p.grad.clone()
                               for n, p in tr.model.named_parameters()},
                        {n: t.clone() for n, t in tr.model.named_buffers()
                         if "running_" in n}))
    (loss_k, grads_k, bn_k), (loss_p, grads_p, bn_p) = results
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    floor = 1e-4 * max(g.abs().max().item() for g in grads_p.values())
    for n, g in grads_p.items():
        err = ((grads_k[n] - g).abs().max().item()
               / max(g.abs().max().item(), floor))
        assert err <= 1.5e-3, n
    for n, t in bn_p.items():
        assert (bn_k[n] - t).abs().max().item() <= 1e-5, n
