"""The port learns: tests/test_convergence.py's recipe on the port.

A tiny arch3 trained for 150 steps on ``synthetic_confusion_dataset`` (a
fixed confusion map a model can invert) must reach held-out
sent-correct-F1 and sent-detect-F1 above 50, scored by the port's SIGHAN
metric, on the CPU through the plain versions of the kernels. The JAX
package's test (``realise_tpu``'s own weights and glyph placeholder) is
the reference recipe; here the port's seeded weights, the procedural
glyphs and the pinyin tables, as ``cli/train`` installs them, so the
factorized streams train too. ``chip_smoke.py`` runs the same recipe on
the card with the kernels.
"""

import numpy as np
import pytest
import torch

from realise_tpu.config import config_for as jax_config_for
from realise_tpu_torch.cli.common import evaluate_model
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.data.dataset import batch_iterator, synthetic_confusion_dataset
from realise_tpu_torch.data.features import Featurizer
from realise_tpu_torch.models.realise import Realise
from realise_tpu_torch.text.glyphs import build_glyph_table
from realise_tpu_torch.text.tokenizer import WordPieceTokenizer
from realise_tpu_torch.text.vocab import build_synthetic_vocab, vocab_to_dict
from realise_tpu_torch.training.trainer import Trainer
from torch_port_fixtures import one_intra_op_thread

# tests/test_convergence.py's config, read from the JAX package's presets.
CFG = RealiseConfig.from_dict(jax_config_for(
    "bert-pho2-res-arch3", vocab_size=300, hidden_size=32,
    num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
    pho_num_layers=1, out_num_layers=1, max_seq_length=16,
    max_position_embeddings=32, num_fonts=1, hidden_dropout_prob=0.0,
    attention_probs_dropout_prob=0.0).to_dict())


@pytest.fixture(autouse=True)
def _one_thread():
    with one_intra_op_thread():
        yield


def test_heldout_f1_above_50(tmp_path):
    vocab = build_synthetic_vocab(size=300)
    tokenizer = WordPieceTokenizer(vocab_to_dict(vocab))
    assert len(tokenizer) == CFG.vocab_size
    feat = Featurizer(tokenizer, CFG)
    train = synthetic_confusion_dataset(tokenizer, num_examples=512,
                                        max_len=12, seed=1)
    heldout = synthetic_confusion_dataset(tokenizer, num_examples=96,
                                          max_len=12, seed=2)
    model = Realise(CFG, generator=torch.Generator().manual_seed(0))
    model.install_glyphs(build_glyph_table(vocab, num_fonts=1,
                                           use_traditional_font=False))
    model.install_pho_vocab_tables(*feat.pho2_tables())
    tr = Trainer(CFG, model, learning_rate=3e-3, warmup_steps=20,
                 total_steps=150, max_grad_norm=1.0, seed=11, device="cpu")

    def batches():
        epoch = 0
        while True:
            for ex in batch_iterator(train, 64, shuffle=True, seed=epoch):
                yield feat.device_batch(feat.featurize(ex))
            epoch += 1

    summary = tr.fit(batches(), max_steps=150, logging_steps=0)
    assert np.isfinite(summary["final_loss"])
    assert summary["final_loss"] < 1.0, summary

    res = evaluate_model(tr, heldout, feat, tokenizer, str(tmp_path),
                         batch_size=32)
    # 96 examples at batch 32 also run the padded eval path.
    assert res["sent-correct-f1"] > 50, res
    assert res["sent-detect-f1"] > 50, res
