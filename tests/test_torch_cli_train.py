"""The port's training CLI (realise_tpu_torch/cli/train.py) and the data and
glyph copies it runs on, against the JAX package's."""

import threading
import time

import numpy as np
import pytest
import torch

from realise_tpu.data.dataset import synthetic_dataset as jax_synthetic
from realise_tpu.text.glyphs import build_glyph_table as jax_glyphs
from realise_tpu.text.tokenizer import WordPieceTokenizer as JaxTokenizer
from realise_tpu_torch.cli import train as ttrain
from realise_tpu_torch.data import dataset as tdata
from realise_tpu_torch.text.glyphs import build_glyph_table
from realise_tpu_torch.text.tokenizer import WordPieceTokenizer
from realise_tpu_torch.text.vocab import build_synthetic_vocab, vocab_to_dict
from realise_tpu_torch.training.checkpoint import list_checkpoints


@pytest.fixture(scope="module")
def small_vocab():
    return build_synthetic_vocab(size=400, cjk_chars=300)


def test_synthetic_dataset_matches_jax(small_vocab):
    ours = tdata.synthetic_dataset(WordPieceTokenizer(vocab_to_dict(small_vocab)),
                                   num_examples=20, seed=3)
    theirs = jax_synthetic(JaxTokenizer(vocab_to_dict(small_vocab)),
                           num_examples=20, seed=3)
    assert ours == theirs


@pytest.mark.parametrize("num_fonts, trad", [(3, True), (1, False)])
def test_glyph_table_matches_jax(small_vocab, num_fonts, trad):
    """The procedural fallback (no font files) gives the JAX package's table."""
    np.testing.assert_array_equal(
        build_glyph_table(small_vocab, num_fonts=num_fonts,
                          use_traditional_font=trad),
        jax_glyphs(small_vocab, num_fonts=num_fonts, use_traditional_font=trad))


def test_batching_pads_and_prefetch_propagates():
    data = [{"id": i} for i in range(5)]
    got = [[ex["id"] for ex in b] for b in tdata.batch_iterator(data, 2)]
    assert got == [[0, 1], [2, 3], [4, 4]]
    assert len(list(tdata.batch_iterator(data, 2, drop_remainder=True))) == 2
    assert list(tdata.threaded_prefetch(iter(range(7)), size=2)) == list(range(7))

    def boom():
        yield 1
        raise KeyError("x")

    with pytest.raises(KeyError):
        list(tdata.threaded_prefetch(boom()))


@pytest.mark.parametrize("blocked", ["on the full queue",
                                     "inside the source iterator"])
def test_prefetch_worker_is_joined_on_close(blocked):
    """Closing the stream stops the worker and joins it: one waiting to put
    into the full queue, and one inside the source's ``next`` (joined once
    that item is made, 0.5 s here)."""
    release = threading.Event()

    def source():
        for i in range(10 ** 6):
            if blocked == "inside the source iterator" and i == 1:
                release.wait(0.5)
            yield i

    before = set(threading.enumerate())
    stream = tdata.threaded_prefetch(source(), size=2)
    assert next(stream) == 0
    (worker,) = [t for t in threading.enumerate() if t not in before]
    time.sleep(0.3)  # the queue fills, or the worker waits in the source
    assert worker.is_alive()
    stream.close()
    assert not worker.is_alive()


def test_cli_trains_and_the_corrector_serves(tmp_path):
    """--synthetic --tiny --max_steps 2 on the CPU writes a port checkpoint
    that the Corrector loads and serves."""
    from realise_tpu_torch.serving import Corrector

    out = tmp_path / "out"
    assert ttrain.main(["--synthetic", "--tiny", "--max_steps", "2", "--device",
                        "cpu", "--output_dir", str(out),
                        "--per_device_train_batch_size", "4",
                        "--gradient_accumulation_steps", "2",
                        "--no_prefetch"]) == 0
    ckpts = list_checkpoints(str(out))
    assert [step for step, _ in ckpts] == [2]
    sd = torch.load(f"{ckpts[0][1]}/model.pt", weights_only=True)
    assert int(sd["resnet.res_block1.shortcut.1.num_batches_tracked"]) == 4
    corrector = Corrector(str(out), synthetic_vocab=True, device="cpu")
    assert not corrector.use_kernels
    got = corrector.correct(["我爱北经。", "天气很好"])
    assert [len(s) for s in got] == [5, 4]


def test_cli_refuses_unported_flags_and_missing_cuda(tmp_path, monkeypatch):
    """--distributed needs torchrun's environment, --mesh the JAX syntax and
    a mesh the process group holds (tests/test_torch_parallel_cli.py runs
    them under two ranks); without --device and without CUDA it raises."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        ttrain.main(["--synthetic", "--output_dir", str(tmp_path),
                     "--distributed"])
    with pytest.raises(SystemExit, match="--mesh: bad axis 'data:2'"):
        ttrain.main(["--synthetic", "--output_dir", str(tmp_path),
                     "--mesh", "data:2"])
    with pytest.raises(SystemExit, match="needs 2 processes"):
        ttrain.main(["--synthetic", "--output_dir", str(tmp_path),
                     "--mesh", "data=2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--synthetic", "--tiny", "--max_steps", "1",
                     "--output_dir", str(tmp_path)])
