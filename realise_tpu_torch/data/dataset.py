"""Batching, synthetic data, gold label lines and host prefetch (the port's
own copy of the training and eval half of ``realise_tpu.data.dataset``).

Examples are the reference's per-example dicts ``{id, src, tgt, tokens_size,
src_idx, tgt_idx, lengths}`` (process_data.py:38-45). A short final batch
is padded by repeating its last example, never dropped; callers zero the
padded rows' loss (``cli.common.zero_padding_loss``).
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Sequence, Tuple

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


def bucketed_batch_iterator(dataset: Sequence[Dict], batch_size: int,
                            buckets: Sequence[int] = (32, 64, 128),
                            shuffle: bool = False, seed: int = 0,
                            pad_final: bool = True
                            ) -> Iterator[Tuple[int, List[Dict]]]:
    """(bucket length, examples) batches, each to be padded only to its
    bucket's length (the reference sorts and batches by length,
    data_process/dataset.py:106-175). Examples are binned on
    ``len(src_idx)`` (the sentence with [CLS] and [SEP]); one longer than
    the largest bucket goes to the largest and is cut there. Each bucket
    ends with a short batch of its own, so an epoch yields
    ``sum(ceil(n_b / batch_size))`` batches over the buckets' counts n_b.
    With ``shuffle``, one ``random.Random(seed)`` shuffles each bucket's
    examples in bucket order, then the batches: the JAX package's
    ``bucketed_batch_iterator``, batch for batch."""
    buckets = sorted(buckets)
    binned: Dict[int, List[int]] = {b: [] for b in buckets}
    for i, ex in enumerate(dataset):
        n = len(ex["src_idx"])
        binned[next((b for b in buckets if n <= b), buckets[-1])].append(i)
    rng = random.Random(seed)
    order: List[Tuple[int, List[int]]] = []
    for b, idxs in binned.items():
        if shuffle:
            rng.shuffle(idxs)
        order += [(b, idxs[i:i + batch_size])
                  for i in range(0, len(idxs), batch_size)]
    if shuffle:
        rng.shuffle(order)
    for b, idx in order:
        batch = [dataset[j] for j in idx]
        if len(batch) < batch_size and pad_final:
            batch = pad_examples(batch, batch_size)
        yield b, batch


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


def synthetic_confusion_dataset(tokenizer, num_examples: int = 512,
                                min_len: int = 4, max_len: int = 12,
                                error_rate: float = 0.3,
                                seed: int = 0) -> List[Dict]:
    """Synthetic CSC data whose errors a model can learn: the sorted CJK
    vocab splits into a "content" half and an "error" half, targets draw
    content chars, and each corrupted position takes the content char's
    image under one fixed injective confusion map. An error char thus always
    decodes to the same content char, and a model that learns the map
    reaches a high held-out F1 (``synthetic_dataset``'s uniform noise cannot
    be inverted). The JAX package's ``synthetic_confusion_dataset``, example
    for example for the same tokenizer and seed."""
    rng = random.Random(seed)
    cjk = sorted(t for t in tokenizer.vocab
                 if len(t) == 1 and is_chinese_char(ord(t)))
    if len(cjk) < 16:
        raise ValueError("tokenizer vocab has too few CJK chars")
    half = len(cjk) // 2
    confusion = dict(zip(cjk[:half], cjk[half:2 * half]))
    content = cjk[:half]
    data = []
    for n in range(num_examples):
        length = rng.randint(min_len, max_len)
        tgt = [rng.choice(content) for _ in range(length)]
        src = [confusion[c] if rng.random() < error_rate else c for c in tgt]
        data.append(make_example(f"{20000 + n}", "".join(src), "".join(tgt),
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
    featurization overlaps device work. A sentinel ends the iteration, and
    exceptions reach the consumer. Closing the generator (or a consumer
    that stops early and lets it go) stops the worker and joins it: a
    worker waiting on the full queue gives up within 0.2 s, one inside
    ``iterator`` when its current item is made, so no thread outlives the
    stream."""
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

    t = threading.Thread(target=worker, daemon=True,
                         name="threaded_prefetch")
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
        t.join()
