"""The HTTP daemon under a closed loop: ``serve_open``'s daemon (``cli/serve``
over a ``Corrector`` with tables, kernels, the native featurizer and the
cross-request batcher), driven by ``clients`` callers that each send their
next request as soon as their previous answer came.

Set-up is ``serve_open.daemon``'s (a checkpoint of the seeded weights,
loaded through the Corrector's normal path, every (batch, length) bucket
warmed), then ``warm_seconds`` of the same closed loop over HTTP.

The window is ``benchmark/loadgen.py``'s closed loop in a child process:
``--seconds`` in which the clients send, then the answers still in flight.
The requests are a list of ``requests`` bodies that the clients take in
order: their sizes (sentences by ``mix``) and the sentence lengths are
the same in every run (``shape_seed``); ``--seed`` shares the
lengths out inside each block of ``LENGTH_BLOCK`` sentences, so every
stretch of the list holds the same lengths, and draws the chars.
``serve_sent_per_s`` is the sentences of every request answered with a 200,
over the window from the first send to the last answer; a request with no
200 counts as failed. Each request's latency, from sending to its answer,
goes to standard error as p50 and p95.

Everything but the load and the metric is ``serve_open.serve``'s.

``correct`` is ``serve_open.check``'s: a seeded sample of the answered
requests (the one with the most tokens always in it) against the
reference's logits (``served_gap``), and a seeded sample of device steps
(``step_gap``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from benchmark import inputs
from benchmark.harness import log
from benchmark.traffic.serve_open import body, fill, run_loadgen, serve

LENGTH_BLOCK = 1024


def requests(sent: inputs.Sentences, seed: int, p: Dict) -> List[List[str]]:
    """The list the clients take from: ``p["requests"]`` requests."""
    shape = np.random.default_rng([p["shape_seed"], 3])
    sizes = shape.choice(p["mix_sizes"], p["requests"], p=p["mix_shares"])
    total = int(sizes.sum())
    blocks = -(-total // LENGTH_BLOCK)
    rng = np.random.default_rng([seed, 3])
    lengths = rng.permuted(sent.lengths(blocks * LENGTH_BLOCK).reshape(
        blocks, LENGTH_BLOCK), axis=1).reshape(-1)[:total]
    return fill(sent, rng, lengths, sizes)


def closed_loop(port: int, bodies: List[str], p: Dict, seconds: float,
                tmp: str, tag: str) -> Dict:
    return run_loadgen({"port": port, "clients": p["clients"],
                        "seconds": seconds, "timeout": p["request_timeout_s"],
                        "requests": bodies}, tmp, tag)


def warm(r, sent, port: int, tmp: str):
    reqs = requests(sent, r.seed + 1, dict(r.params, requests=min(
        r.params["requests"], 256)))
    closed_loop(port, [body(s) for s in reqs], r.params,
                r.params["warm_seconds"], tmp, "warm")


def window(r, sent, port: int, seconds: float, tmp: str):
    """The closed loop for ``seconds``: ([(sentences, status, latency,
    payload)] in the order sent, the seconds from the first send to the
    last answer)."""
    reqs = requests(sent, r.seed, r.params)
    res = closed_loop(port, [body(s) for s in reqs], r.params, seconds, tmp,
                      "window")
    rows = [(reqs[i], status, latency, payload)
            for i, status, latency, _, payload in res["results"]]
    log(f"{r.name}: {r.params['clients']} clients took the list of "
        f"{len(reqs)} requests {len(rows) / len(reqs):.2f} times in "
        f"{seconds} s of sending")
    return rows, res["window_s"]


def end_to_end(lat: List[float], sentences: int, seconds: float) -> Dict:
    return {"serve_sent_per_s": sentences / seconds}


def run(r) -> Dict:
    return serve(r, warm, window, end_to_end)
