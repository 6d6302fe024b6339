"""The port's span recorder (``utils/profiler.SpanRecorder``) and the spans
of the fine-tuning step: the recorder on the CPU, the hook's default, and
one ``Trainer.fit`` step whose spans cover it, each phase once and none
inside another; on the kernel path, one span per encoder layer's attention
and FFN backward, with the same gradients as without spans."""

import contextlib
import time
from collections import Counter

import numpy as np
import pytest
import torch

from realise_tpu_torch.config import PHO2_VOCAB_SIZE, config_for
from realise_tpu_torch.models import realise as trealise
from realise_tpu_torch.training.trainer import Trainer
from realise_tpu_torch.utils.profiler import SpanRecorder, no_span
from torch_port_fixtures import one_intra_op_thread

V, B, S = 80, 4, 10
FORWARD = {"bert-pho2-res-arch3": ["semantic", "glyph", "gru", "pho_bert",
                                   "fusion+output", "head+ce"],
           "bert": ["semantic", "fusion+output", "head+ce"]}


@pytest.fixture(autouse=True)
def _one_thread():
    with one_intra_op_thread():
        yield


def _cfg(preset, **kw):
    """A tiny preset with its published layer counts (arch3 12 + 4 + 3,
    bert 12)."""
    return config_for(preset, vocab_size=V, hidden_size=16,
                      num_attention_heads=2, intermediate_size=32,
                      max_seq_length=16, max_position_embeddings=16,
                      num_fonts=1, **kw)


def _model(cfg):
    model = trealise.Realise(cfg, generator=torch.Generator().manual_seed(0))
    if cfg.with_res:
        gen = torch.Generator().manual_seed(1)
        model.install_glyphs((torch.rand(model.char_images_multifonts.shape,
                                         generator=gen) < 0.5).float())
    return model


def _batch(seed=3):
    r = np.random.RandomState(seed)
    masks = np.ones((B, S), np.int64)
    masks[1, 6:] = 0
    return {"src_idx": r.randint(0, V, (B, S)),
            "tgt_idx": r.randint(0, V, (B, S)),
            "masks": masks, "loss_masks": masks.copy(),
            "pho_idx": r.randint(1, PHO2_VOCAB_SIZE, (B, S, 8)),
            "pho_lens": r.randint(0, 9, (B, S))}


class Nesting:
    """A span hook that logs each span's entry and exit, then delegates to
    ``inner``: the log shows which span ran inside which."""

    def __init__(self, inner):
        self.inner, self.log = inner, []

    @contextlib.contextmanager
    def span(self, name):
        self.log.append(("enter", name))
        with self.inner(name):
            yield
        self.log.append(("exit", name))


def test_recorder_nests_spans_and_totals_them_by_name():
    rec = SpanRecorder("cpu")
    for _ in range(2):
        with rec.span("outer"):
            for _ in range(3):
                with rec.span("inner"):
                    torch.ones(8).sum()
    got = rec.totals()
    assert set(got) == {"outer", "inner"}
    assert (got["outer"]["count"], got["inner"]["count"]) == (2, 6)
    assert got["outer"]["host_ms"] >= got["inner"]["host_ms"] > 0
    assert all(set(t) == {"count", "host_ms"} for t in got.values())


def test_recorder_records_host_ms_on_the_cpu_and_when_the_body_raises():
    rec = SpanRecorder("cpu")
    with rec.span("sleep"):
        time.sleep(0.02)
    with pytest.raises(ValueError):
        with rec.span("raises"):
            raise ValueError
    got = rec.totals()
    assert got["sleep"]["host_ms"] >= 20.0
    assert got["raises"]["count"] == 1


def test_recorder_spans_are_ranges_of_a_profiler_trace():
    rec = SpanRecorder("cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.span("phase"):
            torch.mm(torch.ones(4, 4), torch.ones(4, 4))
    names = {e.name for e in prof.events()}
    assert {"phase", "aten::mm"} <= names


def test_no_span_is_the_default_hook():
    """The model's hook defaults to ``no_span`` (imported from
    ``models/realise``, where callers find it), which brackets nothing."""
    model = _model(_cfg("bert"))
    assert trealise.no_span is no_span
    assert model.span is no_span
    assert Trainer(model.cfg, model, use_kernels=False,
                   device="cpu").model.span is no_span
    with no_span("anything") as got:
        assert got is None


def _step_ops(trainer, batch):
    """The op names one step runs on the CPU and how often."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.fit(iter([batch]), max_steps=trainer.step + 1,
                    logging_steps=0)
    return Counter(e.name for e in prof.events())


def test_default_hook_runs_no_span_and_the_recorder_adds_no_op():
    """With the default hook no span range runs; with the recorder the step
    runs the same operators, and only the spans' ranges are added."""
    cfg, batch = _cfg("bert-pho2-res-arch3"), _batch()
    plain = Trainer(cfg, _model(cfg), use_kernels=True, device="cpu")
    traced = Trainer(cfg, _model(cfg), use_kernels=True, device="cpu")
    traced.model.span = SpanRecorder("cpu").span
    want, got = _step_ops(plain, batch), _step_ops(traced, batch)
    spans = {"input", "prep", "upload", "grads", "backward", "clip+adamw",
             "encoder.attn_bwd", "encoder.ffn_bwd", *FORWARD[cfg.model_type]}
    assert not spans & set(want)
    assert spans <= set(got)
    assert {k: v for k, v in got.items() if k not in spans} == dict(want)


@pytest.mark.parametrize("preset", sorted(FORWARD))
@pytest.mark.parametrize("log_and_save", [False, True])
def test_fit_step_spans_cover_it_each_once_and_none_inside_another(
        preset, log_and_save):
    """One step of ``fit`` on the plain path: 'input', 'prep', 'upload', the
    forward's spans, 'backward', 'grads' and 'clip+adamw' (and 'log' and
    'save' when the step logs and saves), each once, one after another."""
    cfg = _cfg(preset)
    trainer = Trainer(cfg, _model(cfg), use_kernels=False, device="cpu")
    rec = SpanRecorder("cpu")
    hook = Nesting(rec.span)
    trainer.model.span = hook.span
    kw = (dict(logging_steps=1, log_fn=lambda r: None, save_steps=1,
               save_fn=lambda step, tr: None) if log_and_save
          else dict(logging_steps=0))
    trainer.fit(iter([_batch()]), max_steps=1, **kw)
    want = (["input", "prep", "upload"] + FORWARD[preset]
            + ["backward", "grads", "clip+adamw"]
            + (["log", "save"] if log_and_save else []))
    assert hook.log == [(e, name) for name in want
                        for e in ("enter", "exit")]
    assert {name: t["count"] for name, t in rec.totals().items()} == (
        dict.fromkeys(want, 1))


@pytest.mark.parametrize("preset,layers", [("bert-pho2-res-arch3", 19),
                                           ("bert", 12)])
def test_kernel_path_spans_each_encoder_backward_inside_backward(
        preset, layers):
    """The train blocks' Functions (their plain versions on the CPU) bracket
    their backwards, one span of each kind per encoder layer, inside
    'backward'; the step's gradients and weights are those of the step
    without spans, bit for bit."""
    cfg, batch = _cfg(preset), _batch()
    plain = Trainer(cfg, _model(cfg), use_kernels=True, device="cpu")
    traced = Trainer(cfg, _model(cfg), use_kernels=True, device="cpu")
    rec = SpanRecorder("cpu")
    hook = Nesting(rec.span)
    traced.model.span = hook.span
    plain.fit(iter([batch]), max_steps=1, logging_steps=0)
    traced.fit(iter([batch]), max_steps=1, logging_steps=0)
    counts = {name: t["count"] for name, t in rec.totals().items()}
    assert counts["encoder.attn_bwd"] == counts["encoder.ffn_bwd"] == layers
    names = [name for _, name in hook.log]
    first, last = names.index("backward"), len(names) - 1 - names[::-1].index(
        "backward")
    assert all(first < i < last for i, name in enumerate(names)
               if name.startswith("encoder."))
    for (name, p), q in zip(plain.model.named_parameters(),
                            traced.model.parameters()):
        assert torch.equal(p.grad, q.grad), name
        assert torch.equal(p, q), name
