"""The HTTP daemon under open-loop traffic: ``cli/serve.serve`` over a
``Corrector`` with the native featurizer and the cross-request batcher.

Set-up writes a checkpoint of the benchmark's seeded weights under
``TMPDIR`` (deleted at exit), loads it through the Corrector's normal path
(tables, kernels), binds the server on a free port of 127.0.0.1 in this
process, warms every (batch, length) bucket (``Corrector.warmup``) and
sends a few requests over HTTP.

The window is ``benchmark/loadgen.py`` in a child process: requests due on
a Poisson schedule at the mix's ``rate``, whatever is still in flight. Its
arrivals, sizes (1, 8 or 32 sentences by ``mix``) and sentence lengths are
the same in every run (``shape_seed``); ``--seed`` shares the lengths out
and draws the chars. ``serve_p50_ms`` / ``serve_p95_ms`` are percentiles over every
request due in the window, each timed from its due time to its answer; a
request with no 200 answer counts as infinitely late.

``correct``: a seeded sample of the answered requests (the one with the
most tokens always in it) is compared with the reference's logits
(``served_gap``), and so are the argmax rows of a seeded sample of device
steps, kept by a wrapper of this Corrector's ``logits`` (``step_gap``).
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import inputs
from benchmark.harness import Trace, card_kind, log, settle
from benchmark.reference import compare, reference_class, text
from benchmark.traffic.train_stream import program_config

LOADGEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "loadgen.py")


def schedule(sent: inputs.Sentences, seed: int, p: Dict, seconds: float):
    """[(due seconds, [sentences])]: the same arrivals and request sizes in
    every run (``shape_seed``), and the same sentence lengths, which
    ``seed`` shares out over the requests and fills with chars."""
    shape = np.random.default_rng([p["shape_seed"], 3])
    rate = p["rate"]
    gaps = shape.exponential(1.0 / rate, int(rate * seconds * 2) + 64)
    n = int(np.searchsorted(np.cumsum(gaps), seconds))
    gaps = gaps[:n]
    sizes = shape.choice(p["mix_sizes"], n, p=p["mix_shares"])
    lengths = sent.lengths(int(sizes.sum()))
    rng = np.random.default_rng([seed, 3])
    lengths = rng.permutation(lengths)
    return list(zip(np.cumsum(gaps).tolist(), fill(sent, rng, lengths, sizes)))


def fill(sent: inputs.Sentences, rng: np.random.Generator,
         lengths: np.ndarray, sizes) -> List[List[str]]:
    """Requests of ``sizes`` sentences each, whose sentences take
    ``lengths`` in turn, their chars drawn by ``rng``."""
    ids = sent.draw_ids(rng, int(lengths.sum()))
    out, k, off = [], 0, 0
    for size in sizes:
        batch = []
        for n_chars in lengths[k:k + size]:
            batch.append("".join(sent.chars[ids[off:off + n_chars]]))
            off += n_chars
        k += size
        out.append(batch)
    return out


class StepLog:
    """A wrapper of the Corrector's ``logits``: every step's (rows, length)
    and time, and the inputs and argmax of a seeded sample of steps."""

    def __init__(self, corrector, seed: int, share: float, keep: int,
                 alter: bool = False):
        self.fn = corrector.logits
        self.alter = alter
        self.rng = np.random.default_rng([seed, 4])
        self.share, self.keep = share, keep
        self.shapes: List = []
        self.samples: List = []
        self.lock = threading.Lock()

    def __call__(self, arrays):
        out = self.fn(arrays)
        with self.lock:
            self.shapes.append((time.perf_counter(),) + arrays["src_idx"].shape)
            take = (len(self.samples) < self.keep
                    and self.rng.random() < self.share)
        if self.alter:  # the benchmark's own tests: a token altered
            pred = out.argmax(-1)
            out = out.clone()
            out[:, 1, :] = out.min()
            out[torch.arange(out.shape[0]), 1, (pred[:, 1] + 1) % out.shape[-1]] = out.max() + 1
        if take:
            pred = out.argmax(-1).cpu()
            with self.lock:
                self.samples.append({"src_idx": np.array(arrays["src_idx"]),
                                     "masks": np.array(arrays["masks"]),
                                     "pred": pred})
        return out


class FeaturizeClock:
    """A wrapper of the featurizer's ``featurize_raw``: host seconds."""

    def __init__(self, featurizer):
        self.fn = featurizer.featurize_raw
        self.seconds = 0.0
        self.lock = threading.Lock()

    def __call__(self, *a, **kw):
        t = time.perf_counter()
        out = self.fn(*a, **kw)
        dt = time.perf_counter() - t
        with self.lock:
            self.seconds += dt
        return out


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile; an infinite value sorts last."""
    ordered = sorted(values)
    return ordered[max(math.ceil(q / 100.0 * len(ordered)) - 1, 0)]


@contextlib.contextmanager
def daemon(r):
    """The served daemon of the benchmark's seeded weights: yields (corrector,
    server, vocab, table, cjk, shapes, tmp); stops the server, the batcher
    and deletes the temporary folder (the checkpoint with it) on exit."""
    from realise_tpu_torch.cli.serve import serve
    from realise_tpu_torch.models.realise import Realise
    from realise_tpu_torch.serving import Corrector
    from realise_tpu_torch.training.checkpoint import save_checkpoint

    cfg, p, device = r.cfg, r.params, r.device
    tmp = tempfile.mkdtemp(prefix="bench-")
    try:
        vocab, vocab_path, table = inputs.build_vocab(r.root, cfg, tmp)
        cjk = text.cjk_ids(vocab, table)
        rcfg = program_config(cfg)
        with torch.device("meta"):
            shapes = {k: (tuple(v.shape), v.dtype)
                      for k, v in Realise(rcfg).state_dict().items()}
        weights = inputs.make_weights(shapes, cjk, r.seed, device,
                                      cfg["assumed"]["glyph_density"])
        ckpt = save_checkpoint(os.path.join(tmp, "ckpt"), 0,
                               {k: v.cpu() for k, v in weights.items()}, rcfg)
        del weights
        corrector = Corrector(
            ckpt, vocab_path=vocab_path, batch_size=p["batch"],
            length_buckets=p["buckets"], device=device,
            native_featurizer=True, cross_request_batching=True)
        shutil.rmtree(os.path.join(tmp, "ckpt"))
        server = serve(corrector, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            corrector.warmup(all_buckets=True)
            yield corrector, server, vocab, table, cjk, shapes, tmp
        finally:
            server.shutdown()
            server.server_close()
            corrector.close()
            thread.join()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def body(sentences: List[str]) -> str:
    return json.dumps({"sentences": sentences}, ensure_ascii=False)


def run_loadgen(schedule: Dict, tmp: str, tag: str):
    """Run the load generator over ``schedule`` (``loadgen.py``'s format);
    its results."""
    sched = os.path.join(tmp, f"schedule-{tag}.json")
    res = os.path.join(tmp, f"results-{tag}.json")
    with open(sched, "w", encoding="utf-8") as f:
        json.dump(schedule, f, ensure_ascii=False)
    subprocess.run([sys.executable, LOADGEN, sched, res], check=True)
    with open(res, encoding="utf-8") as f:
        return json.load(f)


def load(port: int, requests, tmp: str, tag: str):
    """The open loop over ``requests`` ([(due, sentences)]); its results."""
    return run_loadgen({"port": port, "requests": [
        [due, body(s)] for due, s in requests]}, tmp, tag)


def warm(r, sent, port: int, tmp: str):
    load(port, schedule(sent, r.seed + 1, dict(r.params, rate=r.params[
        "warm_rate"]), r.params["warm_seconds"]), tmp, "warm")


def window(r, sent, port: int, seconds: float, tmp: str):
    """The open loop for ``seconds``: ([(sentences, status, latency,
    payload)], the window's seconds)."""
    p = r.params
    requests = schedule(sent, r.seed, p, seconds)
    results = load(port, requests, tmp, "window")
    rows = [(s, status, latency, payload) for (_, s), (
        status, latency, _, payload) in zip(requests, results)]
    lat = [x if status == 200 else float("inf")
           for _, status, x, _ in rows]
    by_second: Dict[int, List[float]] = {}
    for (due, _), x in zip(requests, lat):
        by_second.setdefault(int(due), []).append(x)
    log(f"{r.name}: at {p['rate']}/s, p50 ms by second of the window " + " ".join(
        f"{1e3 * percentile(v, 50):.0f}" for _, v in sorted(by_second.items()))
        + f"; p99 {1e3 * percentile(lat, 99):.3f} ms, max "
        f"{1e3 * max(lat, default=0.0):.3f} ms, over 1 s "
        f"{sum(x > 1.0 for x in lat)}, loadgen at most "
        f"{1e3 * max((x[2] for x in results), default=0.0):.3f} ms late")
    return rows, seconds


def end_to_end(lat: List[float], sentences: int, seconds: float) -> Dict:
    big = 1e9  # ms of a request with no answer: past every limit
    return {"serve_p50_ms": min(1e3 * percentile(lat, 50), big),
            "serve_p95_ms": min(1e3 * percentile(lat, 95), big)}


def run(r) -> Dict:
    return serve(r, warm, window, end_to_end)


def serve(r, warm, window, end_to_end) -> Dict:
    """Set-up, the window and the check of a serving cell: the daemon,
    ``warm(r, sent, port, tmp)``, the timed ``window(r, sent, port, seconds,
    tmp)`` and the cell's ``end_to_end(latencies, sentences answered,
    window seconds)`` metrics; then the reference over what was served."""
    with daemon(r) as (corrector, server, vocab, table, cjk, shapes, tmp):
        out = drive(r, corrector, server, vocab, cjk, tmp, warm, window,
                    end_to_end)
    del corrector, server
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    pho = text.pho2_ids(vocab, table, r.cfg["pho2_max_len"])
    out.update(check(r, shapes, cjk, pho, vocab, out.pop("served")))
    return out


def collect(rows):
    """(latencies, served, failed) of [(sentences, status, latency,
    payload)]: a request with no 200 that answers each of its sentences has
    failed, and its latency is infinite."""
    lat, served, failed = [], [], 0
    for sentences, status, latency, payload in rows:
        answer = None
        if status == 200:
            try:
                answer = json.loads(payload).get("results")
            except ValueError:  # a 200 that is no JSON is no answer
                pass
        if answer is None or len(answer) != len(sentences):
            failed += 1
            lat.append(float("inf"))
            continue
        lat.append(latency)
        served.append((sentences, [a["corrected"] for a in answer]))
    return lat, served, failed


def drive(r, corrector, server, vocab, cjk, tmp, warm, window,
          end_to_end) -> Dict:
    p, device = r.params, r.device
    port = server.server_address[1]
    sent = inputs.Sentences(vocab, cjk, p)
    warm(r, sent, port, tmp)
    steps = StepLog(corrector, r.seed, p["sample_step_share"],
                    p["sample_steps"], alter=r.fault == "altered_token")
    corrector.logits = steps
    clock = FeaturizeClock(corrector.featurizer)
    corrector.featurizer.featurize_raw = clock
    seconds = min(r.seconds, p["trace_seconds"]) if r.trace else r.seconds
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    settle()
    t_setup = time.perf_counter()
    steps0 = corrector.steps
    trace = None
    if r.trace:
        trace = Trace(device)
        with trace.window():
            rows, window_s = window(r, sent, port, seconds, tmp)
    else:
        rows, window_s = window(r, sent, port, seconds, tmp)
    n_steps = corrector.steps - steps0
    lat, served, failed = collect(rows)
    n_sent = sum(len(s) for s, _ in served)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    kind = card_kind(device) if device.type == "cuda" else "cpu"
    log(f"{r.name}: set-up {t_setup - r.t_start:.3f} s, {len(rows)} "
        f"requests ({n_sent} sentences answered) in a {window_s:.3f}-s "
        f"window, {failed} failed, {n_sent / window_s:.1f} sentences/s, per "
        f"request p50 {1e3 * percentile(lat, 50):.3f} ms, p95 "
        f"{1e3 * percentile(lat, 95):.3f} ms, {n_steps} device steps, peak "
        f"{peak / 2 ** 30:.2f} GiB")
    obs = {}
    if r.trace:
        obs = {"cfg": r.cfg, "trace": trace.summary, "serve": True,
               "requests": len(served), "sentences": n_sent,
               "device_steps": n_steps,
               "featurize_ms": 1e3 * clock.seconds / max(len(served), 1),
               "step_shapes": [(b, s) for _, b, s in steps.shapes],
               "sentence_tokens": [len(x) + 2 for s, _ in served for x in s]}
    return {"end_to_end": dict(end_to_end(lat, n_sent, window_s),
                               setup_s=t_setup - r.t_start),
            "attempted": len(rows), "failed": failed,
            "memory_peak_bytes": int(peak), "kind": kind,
            "trace": trace.summary if trace else None, "observations": obs,
            "served": {"requests": served, "steps": steps.samples,
                       "failed": failed}}


def sample_requests(served, seed: int, count: int):
    """A seeded sample of answered requests, the one with the most tokens
    always in it."""
    if not served:
        return []
    longest = max(range(len(served)),
                  key=lambda i: sum(len(x) for x in served[i][0]))
    rng = np.random.default_rng([seed, 5])
    rest = [i for i in range(len(served)) if i != longest]
    picked = rng.choice(rest, min(count - 1, len(rest)), replace=False)
    return [served[i] for i in [longest] + sorted(picked.tolist())]


def encode(sentences: List[str], index: Dict[str, int], device):
    """[CLS] ids [SEP] of each sentence, padded: (src_idx, masks)."""
    n = max(len(s) for s in sentences) + 2
    src = torch.zeros((len(sentences), n), dtype=torch.long)
    masks = torch.zeros((len(sentences), n), dtype=torch.long)
    for i, s in enumerate(sentences):
        row = [index["[CLS]"]] + [index.get(c, index["[UNK]"]) for c in s] + [
            index["[SEP]"]]
        src[i, :len(row)] = torch.as_tensor(row)
        masks[i, :len(row)] = 1
    return src.to(device), masks.to(device)


def reference_model(r, shapes, cjk, pho, precision="f32"):
    weights = inputs.make_weights(shapes, cjk, r.seed, r.device,
                                  r.cfg["assumed"]["glyph_density"])
    cls = reference_class(r.cfg)
    return cls(r.cfg, weights, *pho, precision=precision)


def served_numbers(ref, vocab, sample, steps) -> Dict[str, float]:
    index = {t: i for i, t in enumerate(vocab)}
    char_ids, unplaceable = compare.allowed_sets(vocab)
    worst = 0.0
    with torch.no_grad():
        for sentences, corrected in sample:
            src, masks = encode(sentences, index, ref.device)
            logits = ref.forward(src, masks)
            for i, (s, c) in enumerate(zip(sentences, corrected)):
                worst = max(worst, compare.served_gap(
                    logits[i, :len(s) + 2], s, c, src[i, 1:len(s) + 1].tolist(),
                    char_ids, unplaceable))
        step_worst = 0.0
        for st in steps:
            src = torch.as_tensor(st["src_idx"], device=ref.device).long()
            masks = torch.as_tensor(st["masks"], device=ref.device).long()
            logits = ref.forward(src, masks)
            step_worst = max(step_worst, compare.token_gap(
                logits, st["pred"].to(ref.device), masks))
    return {"served_gap": worst, "step_gap": step_worst}


def check(r, shapes, cjk, pho, vocab, served) -> Dict:
    p = r.params
    t = time.perf_counter()
    sample = sample_requests(served["requests"], r.seed, p["sample_requests"])
    ref = reference_model(r, shapes, cjk, pho)
    numbers = served_numbers(ref, vocab, sample, served["steps"])
    log(f"{r.name}: reference over {sum(len(s) for s, _ in sample)} "
        f"sentences and {len(served['steps'])} steps in "
        f"{time.perf_counter() - t:.1f} s")
    verdict = compare.judge(numbers, r.cell["limits"])
    ok = verdict["ok"] and bool(sample) and bool(served["steps"])
    out = {"correct": ok and served["failed"] == 0,
           "checks": verdict["checks"], "numbers": numbers}
    if r.control:
        control = reference_model(r, shapes, cjk, pho, precision="fp8")
        index = {t: i for i, t in enumerate(vocab)}
        gaps = [compare.control_gap(ref, control,
                                    *encode(s, index, ref.device))
                for s, _ in sample]
        steps = [compare.control_gap(
            ref, control,
            torch.as_tensor(st["src_idx"], device=ref.device).long(),
            torch.as_tensor(st["masks"], device=ref.device).long())
            for st in served["steps"]]
        out["control"] = {"served_gap": max(gaps, default=0.0),
                          "step_gap": max(steps, default=0.0)}
    return out


def sweep(r, rates: List[float], seconds: float) -> List[Dict]:
    """One set-up, then the mix at each rate in turn for ``seconds``: how
    far completions kept pace with arrivals. A rate holds when every request
    was answered and the latest fifth of the requests waited no longer than
    twice the earliest fifth (the backlog did not grow)."""
    p, rows = r.params, []
    with daemon(r) as (corrector, server, vocab, _, cjk, _, tmp):
        port = server.server_address[1]
        sent = inputs.Sentences(vocab, cjk, p)
        for k, rate in enumerate(rates):
            reqs = schedule(sent, r.seed + k, dict(p, rate=rate), seconds)
            steps0 = corrector.steps
            res = load(port, reqs, tmp, f"sweep{k}")
            ok = [x for x in res if x[0] == 200]
            lat = [x[1] for x in res]
            fifth = max(len(lat) // 5, 1)
            head = percentile(lat[:fifth], 50)
            tail = percentile(lat[-fifth:], 50)
            row = {"rate": rate, "requests": len(reqs), "answered": len(ok),
                   "sentences": sum(len(s) for _, s in reqs),
                   "p50_ms": 1e3 * percentile(lat, 50),
                   "p95_ms": 1e3 * percentile(lat, 95),
                   "first_fifth_p50_ms": 1e3 * head,
                   "last_fifth_p50_ms": 1e3 * tail,
                   "device_steps": corrector.steps - steps0,
                   "max_late_ms": 1e3 * max(x[2] for x in res),
                   "holds": len(ok) == len(reqs) and tail <= 2 * head}
            log(f"sweep {json.dumps(row)}")
            rows.append(row)
    return rows
