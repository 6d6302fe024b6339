"""Fine-tuning throughput: ``Trainer.fit`` over ``cli/train``'s pipeline.

Set-up builds one ``Trainer`` (the model built on the meta device and given
the benchmark's seeded weights, AdamW, the recipe's schedule and the
trainer seed ``--seed``) and one stream over a pool of seeded examples:
``bucketed_batch_iterator(shuffle=True)`` by epoch, each batch padded to the
batch size, featurized at its bucket's length, its padded rows' loss
zeroed, the device part taken, all in ``threaded_prefetch``: the stream
``cli/train --length_buckets`` feeds. ``fit`` runs the first three steps
(the ones the reference follows), then ``warmup_steps`` more on the same
stream, so that every bucket's shapes are built before the window.

The window hands ``fit`` the same stream through an iterator that stops
when ``--seconds`` have passed, then waits for the card. ``train_sent_per_s``
is every real (unpadded) sentence of the steps started in the window over
the window's length. A step whose loss is not finite counts as failed.

With ``--trace 1`` the window runs under the profiler, for at most
``trace_seconds``, with the program's spans recorded by its own
``utils/profiler.SpanRecorder``.

One rank of several (``traffic/train_dp.py`` sets ``r.rank``, ``r.world``
and ``r.host_group``) featurizes its slice of each global batch, trains
under ``--mesh data=N``'s Trainer and sends its readings to rank 0, which
alone runs the reference.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import shutil
import tempfile
import time
from typing import Dict, List

import torch

from benchmark import inputs
from benchmark.harness import Trace, TraceSummary, card_kind, log, settle
from benchmark.reference import compare, text

COMPARED_STEPS = 3


class Recorder:
    """The (bucket length, examples) of every batch the stream made, in
    order (step k trains on batch k), and each step's loss."""

    def __init__(self):
        self.batches: List = []
        self.losses: List[torch.Tensor] = []


class Window:
    """The stream until a deadline. With a (host, gloo) ``group`` the ranks
    go on only while every rank's clock is before its deadline, so all run
    the same steps."""

    def __init__(self, stream, deadline: float, group=None):
        self.stream, self.deadline, self.group = stream, deadline, group

    def go(self) -> bool:
        go = time.perf_counter() < self.deadline
        if self.group is None:
            return go
        import torch.distributed as dist

        flag = torch.tensor([int(go)])
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.group)
        return bool(flag[0])

    def __iter__(self):
        while self.go():
            yield next(self.stream)


def program_config(cfg: Dict):
    """The port's config of the preset, with every key of the file that is
    a field of ``RealiseConfig``: a field the file sets always reaches the
    program."""
    from realise_tpu_torch.config import RealiseConfig, config_for

    fields = {f.name for f in dataclasses.fields(RealiseConfig)}
    return config_for(cfg["preset"],
                      **{k: v for k, v in cfg.items() if k in fields})


def build_model(rcfg, cjk, seed, device, density):
    """The program's model on ``device`` with the benchmark's weights."""
    from realise_tpu_torch.models.realise import Realise

    with torch.device("meta"):
        model = Realise(rcfg)
    shapes = {k: (tuple(v.shape), v.dtype)
              for k, v in model.state_dict().items()}
    weights = inputs.make_weights(shapes, cjk, seed, device, density)
    model.load_state_dict(weights, assign=True)
    return model, shapes


def stream(pool, featurizer, batch, buckets, seed, rec: Recorder,
           index: int = 0, size: int = 1):
    """cli/train's batches(), recording each global batch: rank ``index`` of
    ``size`` featurizes its contiguous slice of every global batch."""
    from realise_tpu_torch.cli.common import zero_padding_loss
    from realise_tpu_torch.data.dataset import (
        bucketed_batch_iterator,
        pad_examples,
    )
    from realise_tpu_torch.parallel.distributed import local_slice

    epoch = 0
    while True:
        for seq_len, examples in bucketed_batch_iterator(
                pool, batch, buckets=buckets, shuffle=True,
                seed=seed + epoch, pad_final=False):
            rec.batches.append((seq_len, examples))
            rows = local_slice(pad_examples(examples, batch), index, size)
            feed = featurizer.featurize(rows, seq_len=seq_len)
            feed = zero_padding_loss(feed, len(examples), index * len(rows))
            yield featurizer.device_batch(feed)
        epoch += 1


def run(r) -> Dict:
    from realise_tpu_torch.data.dataset import threaded_prefetch
    from realise_tpu_torch.data.features import Featurizer
    from realise_tpu_torch.text.tokenizer import WordPieceTokenizer
    from realise_tpu_torch.training.trainer import Trainer

    cfg, p, device = r.cfg, r.params, r.device
    tmp = tempfile.mkdtemp(prefix="bench-")
    try:
        vocab, vocab_path, table = inputs.build_vocab(r.root, cfg, tmp)
        cjk = text.cjk_ids(vocab, table)
        tokenizer = WordPieceTokenizer.from_pretrained(vocab_path)
        rcfg = program_config(cfg)
        featurizer = Featurizer(tokenizer, rcfg)
        model, shapes = build_model(rcfg, cjk, r.seed, device,
                                    cfg["assumed"]["glyph_density"])
        model.install_pho_vocab_tables(*featurizer.pho2_tables())
        opt = cfg["optimizer"]
        mesh = None
        if r.world > 1:
            from realise_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh({"data": r.world}, world_size=r.world)
        trainer = Trainer(rcfg, model, learning_rate=opt["learning_rate"],
                          warmup_steps=opt["warmup_steps"],
                          total_steps=opt["total_steps"],
                          weight_decay=opt["weight_decay"],
                          adam_epsilon=opt["adam_epsilon"],
                          max_grad_norm=opt["max_grad_norm"],
                          use_kernels=True, seed=r.seed, device=device,
                          mesh=mesh)
        sent = inputs.Sentences(vocab, cjk, p)
        pool = inputs.training_pool(sent, r.seed, p["pool"], p["error_rate"],
                                    tokenizer.vocab["[CLS]"],
                                    tokenizer.vocab["[SEP]"])
        rec = Recorder()
        step_fn = trainer.train_step

        def recorded_step(batch):
            if r.fault == "half_batch":  # the benchmark's own tests
                batch = {k: v[:len(v) // 2] for k, v in batch.items()}
            loss = step_fn(batch)
            rec.losses.append(loss.detach())
            return loss

        trainer.train_step = recorded_step
        if r.fault == "unchanged_state":
            trainer.optimizer.step = frozen(trainer.optimizer.step,
                                            list(trainer.model.parameters()))
        if r.fault == "no_exchange":
            trainer.all_reduce_sum = lambda tensors: None
        if r.fault == "dropped_rank" and r.rank == r.world - 1:
            trainer.all_reduce_sum = dropped(trainer.all_reduce_sum)
        # The batches' order (and so the sequence of shapes a window sees)
        # is the mix's, the same in every run; the seed draws the text.
        feed = threaded_prefetch(stream(pool, featurizer, p["batch"],
                                        p["buckets"], p["shape_seed"], rec,
                                        r.rank, r.world))
        try:
            out = drive(r, trainer, feed, rec)
        finally:
            feed.close()
        del trainer, model, feed
        if r.rank:
            return out
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        pho = text.pho2_ids(vocab, table, cfg["pho2_max_len"])
        out.update(check(r, shapes, cjk, pho, rec, out.pop("program"),
                         out["failed"]))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def frozen(step, params):
    """An optimizer step that leaves the parameters as they were (a fault
    for the benchmark's own tests)."""

    def run(*args, **kw):
        before = [q.detach().clone() for q in params]
        step(*args, **kw)
        with torch.no_grad():
            for q, b in zip(params, before):
                q.copy_(b)

    return run


def dropped(all_reduce_sum):
    """The all-reduce with this rank's sums left out: it adds zeros (a fault
    for the benchmark's own tests and calibration)."""

    def run(tensors):
        for t in tensors:
            t.zero_()
        all_reduce_sum(tensors)

    return run


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def drive(r, trainer, feed, rec: Recorder) -> Dict:
    from realise_tpu_torch.utils.profiler import SpanRecorder, no_span

    device, p = r.device, r.params
    trainer.fit(feed, max_steps=1)
    # The first gradient as the optimizer got it: AdamW's first moment
    # after one step is (1 - beta1) times it.
    state = trainer.optimizer.state
    first_grads = {n: state[q]["exp_avg"].detach().to("cpu", copy=True) / 0.1
                   for n, q in trainer.model.named_parameters()}
    grad_norms = {n: float(torch.linalg.vector_norm(g))
                  for n, g in first_grads.items()}
    trainer.fit(feed, max_steps=COMPARED_STEPS)
    snapshot = {n: q.detach().to("cpu", copy=True)
                for n, q in trainer.model.named_parameters()}
    trainer.fit(feed, max_steps=COMPARED_STEPS + p["warmup_steps"])
    sync(device)
    first = len(rec.losses)
    settle()
    t_setup = time.perf_counter()
    spans = trace = None
    if r.trace:
        spans, trace = SpanRecorder(device), Trace(device)
        trainer.model.span = spans.span
        seconds = min(r.seconds, p["trace_seconds"])
        with trace.window():
            t0 = time.perf_counter()
            trainer.fit(Window(feed, t0 + seconds, r.host_group))
        wall = time.perf_counter() - t0
        trainer.model.span = no_span
    else:
        t0 = time.perf_counter()
        trainer.fit(Window(feed, t0 + r.seconds, r.host_group))
        sync(device)
        wall = time.perf_counter() - t0
    steps = list(range(first, len(rec.losses)))
    losses = torch.stack(rec.losses[first:]).float().cpu() if steps else None
    failed = 0 if losses is None else int((~torch.isfinite(losses)).sum())
    sentences = sum(len(rec.batches[k][1]) for k in steps)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    kind = card_kind(device) if device.type == "cuda" else "cpu"
    obs, summary = {}, trace.summary if trace else None
    if r.trace:
        obs = observations(r, steps, rec, spans, summary, wall)
    setup = t_setup - r.t_start
    if r.world > 1:  # every rank's readings to rank 0
        import torch.distributed as dist

        mine = {"wall": wall, "setup": setup, "peak": peak,
                "allreduce_ms": obs.get("span_ms", {}).get("all-reduce"),
                "busy_s": summary.busy_s if summary else None,
                "window_s": summary.window_s if summary else None}
        ranks = [None] * r.world
        dist.all_gather_object(ranks, mine, group=r.host_group)
        wall = max(x["wall"] for x in ranks)
        setup = max(x["setup"] for x in ranks)
        peak = max(x["peak"] for x in ranks)
        log(f"{r.name}: rank {r.rank} of {r.world}: " + json.dumps(ranks))
        if r.trace:
            summary = TraceSummary(
                sum(x["window_s"] for x in ranks) / r.world,
                sum(x["busy_s"] for x in ranks) / r.world,
                summary.kernel_s, summary.idle_gaps)
            obs.update(trace=summary, dp=True, train=False, ranks=r.world,
                       allreduce_ms=max(x["allreduce_ms"] for x in ranks))
    log(f"{r.name}: set-up {setup:.3f} s, window "
        f"{wall:.3f} s, {len(steps)} steps, {sentences} sentences, "
        f"{sentences / wall:.1f} sentences/s, peak {peak / 2 ** 30:.2f} GiB")
    return {"end_to_end": {"train_sent_per_s": sentences / wall,
                           "setup_s": setup},
            "attempted": len(steps), "failed": failed,
            "memory_peak_bytes": int(peak), "kind": kind,
            "trace": summary, "observations": obs,
            "program": {"losses": [float(l) for l in
                                   rec.losses[:COMPARED_STEPS]],
                        "grad_norms": grad_norms, "first_grads": first_grads,
                        "snapshot": snapshot}}


def observations(r, steps, rec, spans, summary, wall) -> Dict:
    totals = spans.totals()
    n = max(len(steps), 1)
    shapes = [(r.params["batch"], rec.batches[k][0]) for k in steps]
    lengths = [len(ex["src_idx"]) for k in steps for ex in rec.batches[k][1]]
    return {"cfg": r.cfg, "trace": summary, "steps": len(steps),
            "step_shapes": shapes, "sentence_tokens": lengths,
            "span_ms": {k: v["device_ms"] / n for k, v in totals.items()},
            "train": True,
            "window_s": wall}


def reference_batches(r, rec):
    """The reference's own arrays of the compared steps' examples, each
    global batch in the ranks' contiguous slices."""
    out = []
    for seq_len, ex in rec.batches[:COMPARED_STEPS]:
        full = inputs.pad_rows(ex, seq_len, r.params["batch"], r.device)
        share = r.params["batch"] // r.world
        out.append([{k: v[i * share:(i + 1) * share] for k, v in full.items()}
                    for i in range(r.world)])
    return out


def check(r, shapes, cjk, pho, rec, program, failed) -> Dict:
    """The reference's first steps from the same weights, batches and
    trainer seed, against the program's readings."""
    cfg, device = r.cfg, r.device
    weights = inputs.make_weights(shapes, cjk, r.seed, device,
                                  cfg["assumed"]["glyph_density"])
    with torch.no_grad():
        change = {}
        for n, after in program.pop("snapshot").items():
            change[n] = float(torch.linalg.vector_norm(
                after.to(device) - weights[n]))
    program["change_norms"] = change
    batches = reference_batches(r, rec)
    t = time.perf_counter()
    want = compare.reference_steps(cfg, weights, pho, batches, r.seed)
    numbers = compare.train_numbers(program, want)
    names = sorted(want["grad_norms"])
    log(f"{r.name}: worst first-gradient leaves "
        f"{compare.worst(program['grad_norms'], want['grad_norms'], names)}; "
        f"worst change leaves "
        f"{compare.worst(program['change_norms'], want['change_norms'], names)}")
    log(f"{r.name}: reference {time.perf_counter() - t:.1f} s; losses "
        f"{program['losses']} against {want['losses']}; first gradient's "
        f"norm before the clip {want['clip_norm']}")
    verdict = compare.judge(numbers, r.cell["limits"])
    out = {"correct": verdict["ok"] and failed == 0,
           "checks": verdict["checks"], "numbers": numbers}
    if r.control:
        got = compare.reference_steps(cfg, weights, pho, batches, r.seed,
                                      precision="fp8")
        out["control"] = compare.train_numbers(got, want)
    return out
