"""The port held to ``apply_realise`` at the published arch3 size, on the CPU.

The published ``bert-pho2-res-arch3`` config, cut nowhere: H=768, 12 heads
of 64, I=3072, 12 + 4 + 3 layers, V=21128, 3 fonts, pho2_max_len 8, float32.
Weights from ``models.convert.seeded_weights`` (numpy, seed 1234), carried to
JAX by the JAX package's own importer (``tests/torch_port_fixtures.
jax_weights``); every glyph row's CharResNet features are live. The batch:
4 sentences of 32, 27, 19 and 9 tokens at S=32 (three rows padded).

Pairings, logits and gates within the tiny tests' 1e-4: ``apply_realise``'s
jnp path with the port's plain sub-blocks (``use_kernels=False``), and its
Pallas kernels in interpret mode with the port's kernel wrappers
(``use_kernels=True``, their plain versions on the CPU); each with and
without the inference tables. The JAX package's full-vocab table build is
slow on the CPU, so the tables are built for the contiguous block of the last
1024 vocab rows, [20104, 21128) (the last row, 21127, among them), on both
sides, and the tables case's batch draws its ids from that block; the other
rows of both sides' (V, H) tables are zero and never gathered.

``tests/golden/port_fullwidth_arch3.npz`` holds the jnp path's outputs on
these weights and batches for ``chip_smoke.py``'s full-width phase, which
reads it with numpy alone; ``test_golden_file`` recomputes it (within 1e-5)
and holds the port's plain path to it (within 1e-4). Rewrite it with

    REALISE_TPU_REGEN_GOLDEN=1 python -m pytest tests/test_torch_fullwidth.py -k golden
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realise_tpu.config import config_for
from realise_tpu.models.realise import apply_realise, precompute_inference_tables
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.models import realise as trealise
from realise_tpu_torch.models.convert import seeded_weights
from torch_port_fixtures import intra_op_threads, jax_weights, live_glyph_rows

SEED = 1234
CFG = config_for("bert-pho2-res-arch3")
PCFG = RealiseConfig.from_dict(CFG.to_dict())
V, H = CFG.vocab_size, CFG.hidden_size
LENGTHS, S = (32, 27, 19, 9), 32
BLOCK = (V - 1024, V)
TOL = 1e-4
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "port_fullwidth_arch3.npz")
GOLDEN_TOL = 1e-5
TOP_K = 8
COLS = np.linspace(0, V - 1, 64).round().astype(np.int32)  # 0 .. 21127


def make_batches(seed):
    """The plain batch (ids over the whole vocab, random pinyin) and the
    tables batch (ids in ``BLOCK``), one mask."""
    rng = np.random.RandomState(seed)
    b = len(LENGTHS)
    masks = (np.arange(S)[None, :] < np.asarray(LENGTHS)[:, None]).astype(np.int32)
    plain = {"src_idx": rng.randint(0, V, (b, S)).astype(np.int32),
             "masks": masks,
             "pho_idx": rng.randint(1, 33, (b, S, CFG.pho2_max_len)).astype(np.int32),
             "pho_lens": rng.randint(0, CFG.pho2_max_len + 1, (b, S)).astype(np.int32)}
    tables = dict(plain, src_idx=rng.randint(*BLOCK, (b, S)).astype(np.int32))
    return plain, tables


def digest(tensors):
    """Per-tensor float64 sum and sum of squares, in name order."""
    names = sorted(tensors)
    arrays = [np.asarray(tensors[k], np.float64) for k in names]
    return (np.asarray(names), np.asarray([a.sum() for a in arrays]),
            np.asarray([np.square(a).sum() for a in arrays]))


def summarize(logits, gates, masks):
    """At every valid position (row-major): the top-8 ids and logits, the
    logits at ``COLS`` and the three gates."""
    pos = np.nonzero(np.asarray(masks))
    lg = np.asarray(logits, np.float32)[pos]
    top = np.argsort(-lg, axis=1, kind="stable")[:, :TOP_K].astype(np.int32)
    return {"top_ids": top, "top_logits": np.take_along_axis(lg, top, 1),
            "col_logits": lg[:, COLS], "gates": np.asarray(gates, np.float32)[pos]}



@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the published-size work here runs beside the other
    test workers, and more threads would take their cores."""
    with intra_op_threads(2):
        yield

@pytest.fixture(scope="module")
def fw():
    """The seeded weights on both sides, the batches, and a cache of each
    side's outputs by (kernels, tables)."""
    sd, pho = seeded_weights(PCFG, SEED)
    with torch.device("meta"):
        model = trealise.Realise(PCFG)
    model.load_state_dict(sd, assign=True)
    params, state = jax_weights(sd, CFG)
    plain, tables = make_batches(SEED + 1)
    return SimpleNamespace(sd=sd, pho=pho, model=model.eval(),
                           params=jax.tree.map(jnp.asarray, params),
                           state=jax.tree.map(jnp.asarray, state),
                           batches={False: plain, True: tables}, cache={})


def block_tables(fw):
    """Both sides' (V, H) 'res' and 'pho' tables, built for ``BLOCK`` alone
    (zero elsewhere): {'jax': {...}, 'port': {...}}, built once."""
    if "tables" not in fw.cache:
        lo, hi = BLOCK
        idx, lens = (t[lo:hi] for t in fw.pho)
        state = dict(fw.state, char_images=fw.state["char_images"][lo:hi])
        got = precompute_inference_tables(fw.params, state, CFG, idx, lens,
                                          batch_size=hi - lo)
        jtables = {k: jnp.zeros((V, H), jnp.float32).at[lo:hi].set(v)
                   for k, v in got.items()}
        with torch.inference_mode():
            rows = {"res": fw.model.res_features(torch.arange(lo, hi)),
                    "pho": fw.model.gru_features(torch.as_tensor(idx).long(),
                                                 torch.as_tensor(lens).long())}
        ttables = {}
        for k, v in rows.items():
            ttables[k] = torch.zeros(V, H)
            ttables[k][lo:hi] = v
        fw.cache["tables"] = {"jax": jtables, "port": ttables}
    return fw.cache["tables"]


def outputs(fw, side, kernels, with_tables):
    """(logits, gates) as numpy of one side's forward on the batch of the
    case, cached."""
    key = (side, kernels, with_tables)
    if key not in fw.cache:
        batch = fw.batches[with_tables]
        tables = block_tables(fw)[side] if with_tables else None
        if side == "jax":
            out = apply_realise(fw.params, fw.state,
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                CFG, use_pallas=kernels, return_gates=True,
                                inference_tables=tables)
        else:
            with torch.inference_mode():
                out = fw.model({k: torch.as_tensor(v, dtype=torch.long)
                                for k, v in batch.items()},
                               tables=tables, use_kernels=kernels,
                               return_gates=True)
            out = {k: v.numpy() for k, v in out.items()}
        fw.cache[key] = (np.asarray(out["logits"]), np.asarray(out["gates"]))
    return fw.cache[key]


def test_every_glyph_row_is_live(fw):
    """All 21128 vocab rows of the glyph stream carry nonzero features, so the
    tables and the glyph stream are compared on live values."""
    assert live_glyph_rows(fw.model) == V


def test_inference_tables_match(fw):
    """The block's 'res' (raw CharResNet features) and 'pho' (GRU last
    hidden) rows, port against the JAX package."""
    lo, hi = BLOCK
    tables = block_tables(fw)
    for k in ("res", "pho"):
        want = np.asarray(tables["jax"][k])[lo:hi]
        print(f"{k} table rows {lo}-{hi - 1}: up to {np.abs(want).max():.3f}, "
              f"largest gap {np.abs(tables['port'][k][lo:hi].numpy() - want).max():.3e}")
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(tables["port"][k][lo:hi].numpy(), want,
                                   atol=TOL, err_msg=k)


@pytest.mark.parametrize("with_tables", [False, True])
@pytest.mark.parametrize("kernels", [False, True])
def test_forward_matches_apply_realise(fw, kernels, with_tables):
    """Logits (up to ~6 in magnitude) and gates at every position, padded
    ones included; the argmax equal at every valid position."""
    got, got_gates = outputs(fw, "port", kernels, with_tables)
    want, want_gates = outputs(fw, "jax", kernels, with_tables)
    assert got.shape == want.shape == (len(LENGTHS), S, V)
    print(f"kernels={kernels} tables={with_tables}: logits up to "
          f"{np.abs(want).max():.3f}, largest gap {np.abs(got - want).max():.3e}, "
          f"gates {np.abs(got_gates - want_gates).max():.3e}")
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(got_gates, want_gates, atol=TOL)
    valid = fw.batches[with_tables]["masks"].astype(bool)
    np.testing.assert_array_equal(got.argmax(-1)[valid], want.argmax(-1)[valid])


def test_golden_file(fw):
    """The golden file's inputs are this test's, its outputs are the jnp
    path's now (within 1e-5), and the port's plain path meets them within
    1e-4."""
    names, sums, sumsq = digest({**{k: v.numpy() for k, v in fw.sd.items()},
                                 "vocab_pho_idx": fw.pho[0],
                                 "vocab_pho_lens": fw.pho[1]})
    fresh = {"seed": np.int64(SEED), "model_type": np.asarray(CFG.model_type),
             "cols": COLS, "digest_names": names, "digest_sum": sums,
             "digest_sumsq": sumsq}
    for with_tables, prefix in ((False, "plain"), (True, "tables")):
        batch = fw.batches[with_tables]
        if not with_tables:
            fresh.update(batch)
        else:
            fresh["tables_src_idx"] = batch["src_idx"]
        logits, gates = outputs(fw, "jax", False, with_tables)
        for k, v in summarize(logits, gates, batch["masks"]).items():
            fresh[f"{prefix}_{k}"] = v
    if os.environ.get("REALISE_TPU_REGEN_GOLDEN"):
        np.savez_compressed(GOLDEN, **fresh)
    with np.load(GOLDEN, allow_pickle=False) as f:
        golden = dict(f)
    assert set(golden) == set(fresh)
    for k in ("seed", "model_type", "cols", "digest_names", "src_idx", "masks",
              "pho_idx", "pho_lens", "tables_src_idx"):
        np.testing.assert_array_equal(golden[k], fresh[k], err_msg=k)
    for k in ("digest_sum", "digest_sumsq"):
        np.testing.assert_allclose(golden[k], fresh[k], rtol=1e-9, atol=1e-6,
                                   err_msg=k)
    for with_tables, prefix in ((False, "plain"), (True, "tables")):
        pos = np.nonzero(fw.batches[with_tables]["masks"])
        top = golden[f"{prefix}_top_ids"]
        for side, kernels, tol in (("jax", False, GOLDEN_TOL),
                                   ("port", False, TOL)):
            logits, gates = outputs(fw, side, kernels, with_tables)
            lg = logits[pos]
            for name, got in (("top_logits", np.take_along_axis(lg, top, 1)),
                              ("col_logits", lg[:, COLS]),
                              ("gates", gates[pos])):
                np.testing.assert_allclose(got, golden[f"{prefix}_{name}"],
                                           atol=tol,
                                           err_msg=f"{side} {prefix} {name}")
        # The file's top-8 are the jnp path's top-8 now, in order.
        want = np.sort(outputs(fw, "jax", False, with_tables)[0][pos], 1)
        np.testing.assert_allclose(golden[f"{prefix}_top_logits"],
                                   want[:, ::-1][:, :TOP_K], atol=GOLDEN_TOL)
