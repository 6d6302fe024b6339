"""Every CLI of the port that has a JAX counterpart takes the JAX CLI's
flags, and ``cli/correct --data_dir`` reads the vocab as the JAX CLI does."""

import importlib
import io

import pytest

from realise_tpu.cli import correct as jcorrect
from realise_tpu_torch.cli import correct as tcorrect
from realise_tpu_torch.cli import train as ttrain
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.text.vocab import REAL_VOCAB_CJK_CHARS, build_synthetic_vocab
from torch_port_fixtures import one_intra_op_thread

# The CLIs with a build_parser() in both packages (cli/exprun has none in
# either).
CLIS = ("correct", "serve", "test", "train", "show_gate", "merge",
        "pretrain_pho", "pretrain_res", "prepare_data")
# The documented renames: the JAX platform and Pallas switches are the
# port's device and kernel switches.
JAX_ONLY = {"--platform", "--use_pallas", "--no_pallas"}
PORT_ONLY = {"--device", "--no_kernels"}
# Left out on purpose (ROADMAP queue A, "Left out on purpose"): a JAX
# rematerialization option for TPU memory.
LEFT_OUT = {"--remat"}


@pytest.fixture(autouse=True)
def _one_thread():
    with one_intra_op_thread():
        yield


def _options(parser):
    return {o for a in parser._actions for o in a.option_strings} - {"-h", "--help"}


@pytest.mark.parametrize("name", CLIS)
def test_port_cli_takes_the_jax_flags(name):
    """The port's option strings are the JAX parser's, less the renames
    and the flags left out on purpose; the data-parallel flags (--mesh,
    --distributed) are taken wherever the JAX CLI takes them."""
    theirs = _options(importlib.import_module(
        f"realise_tpu.cli.{name}").build_parser())
    ours = _options(importlib.import_module(
        f"realise_tpu_torch.cli.{name}").build_parser())
    assert theirs - ours <= JAX_ONLY | LEFT_OUT, theirs - ours
    assert ours - theirs <= PORT_ONLY, ours - theirs
    assert (theirs & {"--mesh", "--distributed"}) <= ours


def test_cli_correct_reads_the_vocab_of_data_dir(tmp_path, monkeypatch, capsys):
    """--data_dir DIR reads DIR/vocab.txt (the JAX ``resolve_vocab_path``):
    a checkpoint trained on the synthetic vocab, served from the same vocab
    written as DIR/vocab.txt, gives the --synthetic answers."""
    out = tmp_path / "out"
    assert ttrain.main(["--synthetic", "--tiny", "--max_steps", "1", "--device",
                        "cpu", "--output_dir", str(out),
                        "--per_device_train_batch_size", "4",
                        "--no_prefetch"]) == 0
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    vocab = build_synthetic_vocab(size=RealiseConfig().vocab_size,
                                  cjk_chars=REAL_VOCAB_CJK_CHARS)
    (data_dir / "vocab.txt").write_text("\n".join(vocab) + "\n",
                                        encoding="utf-8")
    sents = "我爱北经。\n天气很好\n"
    answers = []
    for flags in (["--synthetic"], ["--data_dir", str(data_dir)]):
        monkeypatch.setattr("sys.stdin", io.StringIO(sents))
        assert tcorrect.main(["--ckpt_dir", str(out), "--device", "cpu",
                              "--show_edits"] + flags) == 0
        answers.append(capsys.readouterr().out)
    assert answers[0] == answers[1] and len(answers[0].splitlines()) == 2
    # The JAX CLI's flag, with the same default.
    jargs = jcorrect.build_parser().parse_args(["--ckpt_dir", "x"])
    targs = tcorrect.build_parser().parse_args(["--ckpt_dir", "x"])
    assert jargs.data_dir is None and targs.data_dir is None
