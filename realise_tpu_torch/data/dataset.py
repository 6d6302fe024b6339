"""Batching, synthetic data, gold label lines and host prefetch (the port's
own copy of the training and eval half of ``realise_tpu.data.dataset``).

Examples are the reference's per-example dicts ``{id, src, tgt, tokens_size,
src_idx, tgt_idx, lengths}`` (process_data.py:38-45). A short final batch
is padded by repeating its last example, never dropped; callers zero the
padded rows' loss (``cli.common.zero_padding_loss``).
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Sequence

from realise_tpu_torch.data.features import make_example
from realise_tpu_torch.text.tokenizer import is_chinese_char


def pad_examples(examples: List[Dict], batch_size: int) -> List[Dict]:
    """Repeat the last example to fill a short batch (fixed shapes)."""
    out = list(examples)
    while len(out) < batch_size:
        out.append(examples[-1])
    return out


def batch_iterator(dataset: Sequence[Dict], batch_size: int,
                   shuffle: bool = False, seed: int = 0,
                   drop_remainder: bool = False,
                   pad_final: bool = True) -> Iterator[List[Dict]]:
    order = list(range(len(dataset)))
    if shuffle:
        random.Random(seed).shuffle(order)
    for i in range(0, len(order), batch_size):
        idx = order[i:i + batch_size]
        batch = [dataset[j] for j in idx]
        if len(idx) < batch_size:
            if drop_remainder:
                return
            if pad_final:
                batch = pad_examples(batch, batch_size)
        yield batch


def synthetic_dataset(tokenizer, num_examples: int = 64, min_len: int = 4,
                      max_len: int = 12, error_rate: float = 0.15,
                      seed: int = 0) -> List[Dict]:
    """A synthetic CSC dataset over the tokenizer's CJK vocab: random target
    sentences, sources with ~error_rate of the positions replaced by another
    random CJK char. The JAX package's ``synthetic_dataset`` with its default
    uniform draw, example for example for the same tokenizer and seed."""
    rng = random.Random(seed)
    cjk = [t for t in tokenizer.vocab
           if len(t) == 1 and is_chinese_char(ord(t))]
    if len(cjk) < 8:
        raise ValueError("tokenizer vocab has too few CJK chars")
    data = []
    for n in range(num_examples):
        length = rng.randint(min_len, max_len)
        tgt = [rng.choice(cjk) for _ in range(length)]
        src = list(tgt)
        for i in range(length):
            if rng.random() < error_rate:
                src[i] = rng.choice(cjk)
        data.append(make_example(f"{10000 + n}", "".join(src), "".join(tgt),
                                 tokenizer))
    return data


def dataset_labels(dataset: Sequence[Dict]) -> List[str]:
    """Gold label lines (``id, pos, char, ...`` or ``id, 0``) from the
    examples' src/tgt texts (data_process/build_lbl.py)."""
    lines = []
    for ex in dataset:
        edits = [f"{i}, {b}" for i, (a, b) in
                 enumerate(zip(ex["src"], ex["tgt"]), start=1) if a != b]
        lines.append(f"{ex['id']}, " + ", ".join(edits) if edits
                     else f"{ex['id']}, 0")
    return lines


def threaded_prefetch(iterator, size: int = 2):
    """Run ``iterator`` in a background thread with a bounded queue, so host
    featurization overlaps device work. A sentinel ends the iteration,
    exceptions reach the consumer, and a consumer that stops early releases
    the thread."""
    import queue as queue_mod
    import threading

    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()

    class _Raise:
        def __init__(self, exc):
            self.exc = exc

    def put_with_stop(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put_with_stop(item):
                    return
        except BaseException as e:  # propagate into the consumer
            put_with_stop(_Raise(e))
        finally:
            put_with_stop(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, _Raise):
                raise item.exc
            yield item
    finally:
        stop.set()
