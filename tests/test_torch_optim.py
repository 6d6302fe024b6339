"""The port's optimizer on the CPU: ``training/optim.AdamW`` is
``torch.optim.AdamW`` there, and the Trainer runs the plain path (the
division, ``clip_by_global_norm``, torch's AdamW) with no kernel launched.
The update kernels' host side is held here too: the chunk table that the
two kernels walk, and their arithmetic (per chunk partial sums, the clip
factor, ``group_scalars``) written out in float32 tensor operations,
against the plain path. The kernels themselves run in
``tests/test_torch_cuda.py``."""

import copy

import numpy as np
import pytest
import torch

from realise_tpu_torch.config import PHO2_VOCAB_SIZE, config_for
from realise_tpu_torch.models import realise as trealise
from realise_tpu_torch.ops import bert as tbert
from realise_tpu_torch.ops.kernels import adamw as kadamw
from realise_tpu_torch.training import optim as toptim
from realise_tpu_torch.training.trainer import Trainer
from torch_port_fixtures import one_intra_op_thread

V, B, S = 80, 4, 10


@pytest.fixture(autouse=True)
def _one_thread():
    with one_intra_op_thread():
        yield


def _model():
    cfg = config_for("bert-pho2-res-arch3", vocab_size=V, hidden_size=16,
                     num_attention_heads=2, intermediate_size=32,
                     num_hidden_layers=1, pho_num_layers=1, out_num_layers=1,
                     max_seq_length=16, max_position_embeddings=16,
                     num_fonts=1)
    model = trealise.Realise(cfg, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    model.install_glyphs((torch.rand(model.char_images_multifonts.shape,
                                     generator=gen) < 0.5).float())
    return cfg, model


def _batch(seed):
    r = np.random.RandomState(seed)
    masks = np.ones((B, S), np.int64)
    masks[1, 6:] = 0
    return {"src_idx": r.randint(0, V, (B, S)),
            "tgt_idx": r.randint(0, V, (B, S)),
            "masks": masks, "loss_masks": masks.copy(),
            "pho_idx": r.randint(1, PHO2_VOCAB_SIZE, (B, S, 8)),
            "pho_lens": r.randint(0, 9, (B, S))}


def _counters():
    return (kadamw.global_norm_partials.launches,
            kadamw.adamw_update.launches)


def _assert_state_equal(a, b):
    assert a["param_groups"] == b["param_groups"]
    assert a["state"].keys() == b["state"].keys()
    for i, st in a["state"].items():
        assert list(st) == list(b["state"][i]), i
        for k, v in st.items():
            assert torch.equal(v, b["state"][i][k]), (i, k)


@pytest.mark.parametrize("max_grad_norm", [1e-3, None])
def test_trainer_takes_the_plain_path_on_the_cpu(max_grad_norm):
    """Two CPU steps of a Trainer, its optimizer this module's AdamW,
    against the same Trainer with ``torch.optim.AdamW`` over the same
    groups in its place: the same bits in every weight and in the
    optimizers' state dicts, and no update kernel launched."""
    cfg, model = _model()
    kw = dict(learning_rate=1e-3, weight_decay=0.01,
              max_grad_norm=max_grad_norm, device="cpu", use_kernels=False)
    ours = Trainer(cfg, copy.deepcopy(model), **kw)
    theirs = Trainer(cfg, model, **kw)
    assert type(ours.optimizer) is toptim.AdamW
    assert not ours.optimizer.runs_kernels
    theirs.optimizer = torch.optim.AdamW(
        [dict(g, params=list(g["params"]))
         for g in theirs.optimizer.param_groups], lr=1e-3)
    theirs.optimizer.runs_kernels = False  # what the Trainer asks
    before = _counters()
    for seed in (5, 6):
        a = ours.train_step(_batch(seed))
        b = theirs.train_step(_batch(seed))
        assert torch.equal(a, b)
    assert _counters() == before
    for (n, p), (_, q) in zip(ours.model.named_parameters(),
                              theirs.model.named_parameters()):
        assert torch.equal(p, q), n
    _assert_state_equal(ours.optimizer.state_dict(),
                        theirs.optimizer.state_dict())
    with pytest.raises(ValueError, match="kernel path"):
        ours.optimizer.clip(torch.ones(()), 1.0)


def test_subclass_state_dict_is_torchs():
    """Three steps of this module's AdamW and of ``torch.optim.AdamW`` on
    the same parameters and gradients, one group decayed: equal state
    dicts, and each loads into the other and steps on to the same bits."""
    gen = torch.Generator().manual_seed(0)
    shapes = [(7, 5), (33,), (2, 3, 4)]
    init = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen) for s in shapes]
             for _ in range(4)]

    def make(cls):
        ps = [torch.nn.Parameter(t.clone()) for t in init]
        return ps, cls([{"params": ps[:2], "weight_decay": 0.1},
                        {"params": ps[2:], "weight_decay": 0.0}], lr=1e-2)

    (pa, a), (pb, b) = make(toptim.AdamW), make(torch.optim.AdamW)
    for gs in grads[:3]:
        for ps, opt in ((pa, a), (pb, b)):
            for p, g in zip(ps, gs):
                p.grad = g.clone()
            opt.step()
    _assert_state_equal(a.state_dict(), b.state_dict())
    (pc, c), (pd, d) = make(toptim.AdamW), make(torch.optim.AdamW)
    c.load_state_dict(copy.deepcopy(b.state_dict()))
    d.load_state_dict(copy.deepcopy(a.state_dict()))
    with torch.no_grad():
        for p, q, r in zip(pc, pd, pa):
            p.copy_(r)
            q.copy_(r)
    for ps, opt in ((pa, a), (pb, b), (pc, c), (pd, d)):
        for p, g in zip(ps, grads[3]):
            p.grad = g.clone()
        opt.step()
    for ps in (pb, pc, pd):
        for p, q in zip(ps, pa):
            assert torch.equal(p, q)


def test_kernel_step_bumps_versions_and_the_pack_cache_follows(monkeypatch):
    """The update kernel writes through raw pointers; ``AdamW.step`` bumps
    the version of every tensor it wrote, the parameters and both moments,
    so a BertLayer's cached kernel pack is made again from the new weights.
    The kernel path runs here with stand-ins that write through ``.data``,
    which bumps no version, as a raw pointer does not."""

    class Tables:  # the fields of kadamw.Tables that the optimizer reads
        def __init__(self, params, exp_avgs, exp_avg_sqs, groups, n_split=0):
            self.params = list(params)
            self.moments = (list(exp_avgs), list(exp_avg_sqs))
            self.split_chunks = 0

        def gradient_pointers(self, grads):
            return list(grads)

    def adamw_update(tables, grads, count, max_norm, scalars, norm_out=None):
        for p, g, m, v in zip(tables.params, grads, *tables.moments):
            m.data.add_(g)
            v.data.add_(g * g)
            p.data.sub_(0.1 * g)

    monkeypatch.setattr(kadamw, "Tables", Tables)
    monkeypatch.setattr(kadamw, "adamw_update", adamw_update)
    monkeypatch.setattr(toptim.AdamW, "_on_cuda", lambda self: True)
    layer = tbert.BertLayer(_model()[0])
    opt = toptim.make_optimizer(layer, 1e-3)
    cached = layer.kernel_params(torch.float32)
    gen = torch.Generator().manual_seed(2)
    params = list(layer.parameters())
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen)
    before = [p._version for p in params]
    opt.clip(torch.tensor(1.0), None)
    opt.step()
    assert all(p._version > v for p, v in zip(params, before))
    assert all(opt.state[p][k]._version > 0 for p in params
               for k in ("exp_avg", "exp_avg_sq"))
    att, ffn = layer.kernel_params(torch.float32)
    assert att is not cached[0] and ffn is not cached[1]
    sa = layer.attention.self
    assert torch.equal(att["qkv_weight"], torch.cat(
        [sa.query.weight, sa.key.weight, sa.value.weight]).detach())
    assert torch.equal(ffn["w2"], layer.output.dense.weight.detach())


@pytest.mark.parametrize("numels", [
    [0, 1, 3, kadamw.CHUNK - 1, kadamw.CHUNK, kadamw.CHUNK + 1,
     5 * kadamw.CHUNK + 7],
    list(np.random.RandomState(0).randint(0, 3 * kadamw.CHUNK, 1000)),
])
def test_chunk_table_covers_every_element_once(numels):
    """Each tensor's elements in chunks of CHUNK from its start (so an
    aligned tensor's chunks are 16-byte aligned), in table order; launch
    slices of at most MAX_TENSORS consecutive tensors whose chunk ranges
    tile the table."""
    rows, slices = kadamw.chunk_table(numels)
    for t, n in enumerate(numels):
        starts = rows[rows[:, 0] == t, 1]
        assert list(starts) == list(range(0, n, kadamw.CHUNK))
    assert list(rows[:, 0]) == sorted(rows[:, 0])
    assert kadamw.CHUNK % 4 == 0
    end_tensor = end_chunk = 0
    for first, n, c0, c1 in slices:
        assert (first, c0) == (end_tensor, end_chunk)
        assert 0 < n <= kadamw.MAX_TENSORS
        assert set(rows[c0:c1, 0]) <= set(range(first, first + n))
        end_tensor, end_chunk = first + n, c1
    assert (end_tensor, end_chunk) == (len(numels), len(rows))
    assert len(slices) == -(-len(numels) // kadamw.MAX_TENSORS)


def _kernel_arithmetic(params, grads, moments, groups, count, max_norm, steps,
                       hyper):
    """The two kernels' arithmetic in float32 tensor operations, chunk by
    chunk over ``chunk_table``: the partial sums, their sum in table
    order, the clip factor and each element's update."""
    flat = [g.reshape(-1) for g in grads]
    rows, _ = kadamw.chunk_table([g.numel() for g in grads])
    partials = torch.stack([flat[t][s:s + kadamw.CHUNK].square().sum()
                            for t, s in rows])
    cnt = torch.clamp(count, min=1.0)
    norm = partials.sum().sqrt() / cnt
    factor = (torch.ones(()) if norm < max_norm
              else (1.0 / norm) * torch.tensor(max_norm))
    for p, g, (m, v), gi in zip(params, grads, moments, groups):
        s = [torch.tensor(x, dtype=torch.float32)
             for x in kadamw.group_scalars(*hyper[gi], steps)]
        decay, w1, beta2, w2, step, bc2_sqrt, eps = s
        g = (g / cnt) * factor
        p.mul_(decay)
        m.add_(w1 * (g - m))
        v.mul_(beta2).add_(w2 * (g * g))
        p.add_(step * (m / (v.sqrt() / bc2_sqrt + eps)))
    return norm


@pytest.mark.parametrize("max_norm", [1e-2, 1e6])
def test_kernel_arithmetic_is_the_plain_paths(max_norm):
    """The kernels' arithmetic over three steps, the clip engaged and not,
    two groups (one decayed), a zero gradient, tensors over two chunks:
    parameters and moments within 1e-6 of the largest value of each
    tensor (the norm is summed in another order), the norm within 1e-6."""
    gen = torch.Generator().manual_seed(0)
    shapes = [(3, kadamw.CHUNK // 2 + 5), (17,), (kadamw.CHUNK + 3,), (6, 4)]
    init = [torch.randn(s, generator=gen) for s in shapes]
    hyper = [(2e-3, (0.9, 0.999), 1e-8, 0.01), (2e-3, (0.9, 0.999), 1e-8, 0.0)]
    groups = [0, 1, 0, 1]
    ps = [torch.nn.Parameter(t.clone()) for t in init]
    plain = torch.optim.AdamW(
        [{"params": [p for p, gi in zip(ps, groups) if gi == k],
          "weight_decay": hyper[k][3]} for k in (0, 1)], lr=2e-3)
    ours = [t.clone() for t in init]
    moments = [(torch.zeros_like(t), torch.zeros_like(t)) for t in init]
    count = torch.tensor(37.0)
    for step in (1, 2, 3):
        sums = [torch.randn(s, generator=gen) * 40 for s in shapes]
        sums[1].zero_()  # an unused parameter
        for p, g in zip(ps, sums):
            p.grad = g / count
        want = toptim.clip_by_global_norm([p.grad for p in ps], max_norm)
        plain.step()
        got = _kernel_arithmetic(ours, sums, moments, groups, count,
                                 max_norm, step, hyper)
        assert abs(got.item() - want.item()) <= 1e-6 * want.item()
    assert (want.item() > max_norm) == (max_norm < 1)
    for p, q, (m, v) in zip(ps, ours, moments):
        st = plain.state[p]
        for a, b in ((q, p.detach()), (m, st["exp_avg"]),
                     (v, st["exp_avg_sq"])):
            assert (a - b).abs().max() <= 1e-6 * b.abs().max()
