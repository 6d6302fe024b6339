"""One train step of every fine-tuning preset of the port against the JAX
package's (the configs of tests/test_torch_presets.py).

At dropout 0, float32, tiny widths, every JAX parameter random from a numpy
seed: the loss sum within 1e-6 relative, each gradient of the mean loss
within 5e-5 (the JAX package's own limit between its train kernels and its
jnp path, tests/test_pallas.py:298), the BatchNorm running statistics
within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realise_tpu.models.realise import apply_realise
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.models import realise as trealise
from realise_tpu_torch.models.convert import state_dict_from_jax
from test_torch_presets import (
    CONFIGS,
    PALLAS,
    Pair,
    _t,
    make_batch,
    vocab_tables,
)

GRAD_ATOL, BN_ATOL = 5e-5, 1e-5
# The train batch: more token slots than the JAX package's padded pinyin
# and glyph tables have rows (128), so that both packages factorize.
TB, TS = 6, 24


@pytest.mark.parametrize("name,per_token",
                         [(n, False) for n in CONFIGS]
                         + [("image_model_type=1", True)])
def test_train_step_matches_jax_grad(name, per_token):
    """One train step at dropout 0 on the Trainer's route (the factorized
    GRU, the conv over the batch's own glyph rows; the kernel route, whose
    plain versions run on the CPU, for the configs of PALLAS), or with
    ``per_token`` on the per-token streams (CharResNet1's plain BatchNorm
    statistics), against jax.value_and_grad of apply_realise(train=True)
    with the pinyin tables installed (its factorized streams): the loss sum
    and count, every gradient of the mean loss and the BatchNorm running
    statistics after the step."""
    pair = Pair(name)
    cfg = pair.cfg.replace(hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)
    pcfg = RealiseConfig.from_dict(cfg.to_dict())
    batch = make_batch(3, TB, TS, targets=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        out = apply_realise(p, pair.fstate, jbatch, cfg, deterministic=False,
                            rng=jax.random.PRNGKey(3), train=True)
        return out["loss"], (out["loss_sum"], out["loss_count"], out["state"])

    (_, (ls, lc, new_state)), grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, pair.params))

    m = trealise.Realise(pcfg)
    m.load_state_dict(state_dict_from_jax(pair.params, pair.state, pcfg))
    idx, lens, _ = vocab_tables()
    m.install_pho_vocab_tables(idx, lens)
    m.train()
    if not per_token:
        batch.update(m.conv_rows(batch["src_idx"]))
    out = m(_t(batch), use_kernels=name in PALLAS,
            generator=torch.Generator().manual_seed(1), per_token=per_token)
    assert out["loss_count"].item() == float(lc)
    np.testing.assert_allclose(out["loss_sum"].item(), float(ls), rtol=1e-6)
    (out["loss_sum"] / out["loss_count"]).backward()
    want = state_dict_from_jax(jax.tree.map(np.asarray, grads), pair.state, pcfg)
    for pname, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[pname].numpy(),
                                   atol=GRAD_ATOL, err_msg=pname)
    want_state = state_dict_from_jax(pair.params,
                                     jax.tree.map(np.asarray, new_state), pcfg)
    for bname, buf in m.named_buffers():
        if "running_" in bname:
            np.testing.assert_allclose(buf.numpy(), want_state[bname].numpy(),
                                       atol=BN_ATOL, err_msg=bname)
