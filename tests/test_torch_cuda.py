"""The port's CUDA kernels on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA device:
a CUDA kernel has no CPU mode. The file imports nothing of JAX, so it runs on
a machine that has the card and PyTorch alone (the repository's conftest
imports JAX, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:randomly \\
        --noconftest -o addopts=""
"""

import io

import numpy as np
import pytest
import torch

from realise_tpu_torch.config import config_for
from realise_tpu_torch.models.realise import Realise
from realise_tpu_torch.ops import bert as tbert
from realise_tpu_torch.ops.kernels import bert_block as tbb
from realise_tpu_torch.training.checkpoint import save_checkpoint

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
