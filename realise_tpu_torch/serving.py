"""Serving core: load a checkpoint once, correct sentences fast.

The port of ``realise_tpu.serving``. :class:`Corrector` owns the checkpoint
and config, the tokenizer and featurizer (Python, or the C++ one with
``native_featurizer``), the precomputed per-vocab GRU/glyph tables (the fast
path that takes the conv stack and the GRU loop off the hot loop), the model
on its device and the prediction → text splice. One device step is one
deterministic forward under ``torch.inference_mode()`` ending in argmax;
with ``use_kernels`` every encoder layer runs the two fused block kernels.
Device steps are serialized by a lock. With ``cross_request_batching``,
concurrent requests that share a length bucket ride one device step
(:class:`_CrossRequestBatcher`). The batch CLI (``cli/correct``) and the
HTTP daemon (``cli/serve``) are thin wrappers over it.
"""

from __future__ import annotations

import tempfile
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from realise_tpu_torch.data.features import Featurizer, to_device
from realise_tpu_torch.device import resolve_device
from realise_tpu_torch.eval.metric import Metric
from realise_tpu_torch.models.realise import Realise, precompute_inference_tables
from realise_tpu_torch.ops.kernels import kernels_unviable_reason
from realise_tpu_torch.text.tokenizer import WordPieceTokenizer
from realise_tpu_torch.text.vocab import (
    REAL_VOCAB_CJK_CHARS,
    build_synthetic_vocab,
    vocab_to_dict,
)
from realise_tpu_torch.training.checkpoint import (
    list_checkpoints,
    load_checkpoint,
    load_config,
)


class BatcherClosed(RuntimeError):
    """A submission reached a batcher that ``close()`` has shut."""


class _CrossRequestBatcher:
    """Coalesce concurrent requests' device calls into one step.

    A dedicated device worker takes, in one go, every queued submission that
    shares the head submission's length bucket (up to the device batch size)
    and runs ONE step for the group. While a step is in flight new arrivals
    queue, so under load the group grows toward the batch size with no wait
    timer, and an unloaded request still rides alone. Submissions carry host
    arrays (featurization stays in the request threads); the worker
    concatenates their rows, pads the group to the corrector's batch bucket
    and hands each submission its prediction rows.

    The worker runs its steps on its own thread: ``Corrector.logits`` enters
    inference mode itself, and the kernels launch on the thread's current
    stream, the device's default stream as in the request threads. An error
    of a step reaches every submission of its group. An exception that is
    not an ``Exception`` (``KeyboardInterrupt``, ``SystemExit``, ...) also
    stops the worker; however the worker ends, it marks the batcher failed
    and fails every queued submission, so no ``submit()`` waits on a worker
    that is gone."""

    def __init__(self, corrector: "Corrector"):
        self._c = corrector
        self._cv = threading.Condition()
        self._pending: List[Dict] = []
        self._closed = False
        self._failure: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-device-batcher")
        self._thread.start()

    def submit(self, device_arrays: Dict[str, np.ndarray], n: int,
               seq_len: int) -> np.ndarray:
        """Block until the group step holding these ``n`` rows ran; returns
        this submission's (n, seq_len) prediction rows."""
        sub = {"arrays": device_arrays, "n": n, "seq": seq_len,
               "event": threading.Event(), "preds": None, "err": None}
        with self._cv:
            self._raise_if_stopped()
            self._pending.append(sub)
            self._cv.notify()
        sub["event"].wait()
        if sub["err"] is not None:
            raise sub["err"]
        return sub["preds"]

    def _raise_if_stopped(self) -> None:
        if self._failure is not None:
            raise RuntimeError(
                "the cross-request batcher's device worker has stopped"
            ) from self._failure
        if self._closed:
            raise BatcherClosed("batcher is closed")

    def close(self) -> None:
        """Run what is queued, then stop the worker."""
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join()

    def _take_group(self) -> List[Dict]:
        """Under the cv: pop the head submission plus every same-bucket one
        that still fits the device batch (FIFO: skipped buckets keep their
        order for the next round). The head is taken even when it alone
        exceeds the cap (a direct correct_batch() call larger than
        batch_size): it then rides solo at its own row count."""
        cap = self._c.batch_size
        seq = self._pending[0]["seq"]
        group, rest, total = [], [], 0
        for sub in self._pending:
            if not group or (sub["seq"] == seq and total + sub["n"] <= cap):
                group.append(sub)
                total += sub["n"]
            else:
                rest.append(sub)
        self._pending = rest
        return group

    def _run(self) -> None:
        try:
            while True:
                with self._cv:
                    while not self._pending and not self._closed:
                        self._cv.wait()
                    if not self._pending:
                        return  # closed and drained
                    group = self._take_group()
                self._step(group)
        except BaseException as e:
            with self._cv:
                self._failure = e
            raise
        finally:
            with self._cv:
                if self._failure is None and not self._closed:
                    self._failure = RuntimeError("the worker exited")
                stranded, self._pending = self._pending, []
            for sub in stranded:
                try:
                    self._raise_if_stopped()
                except RuntimeError as err:
                    sub["err"] = err
                sub["event"].set()

    def _step(self, group: List[Dict]) -> None:
        """One device step for ``group``; every submission's event is set
        whatever happens, with its rows or the step's error."""
        c = self._c
        try:
            total = sum(sub["n"] for sub in group)
            # An oversize solo submission exceeds every bucket: it runs at
            # its own row count rather than truncated.
            rows = max(c._batch_bucket_for(total), total)
            arrays = {k: np.concatenate([sub["arrays"][k] for sub in group])
                      for k in group[0]["arrays"]}
            if rows > total:  # pad with copies of the last row
                arrays = {k: np.concatenate(
                    [v, np.repeat(v[-1:], rows - total, axis=0)])
                    for k, v in arrays.items()}
            preds = c._device_step(arrays)
            off = 0
            for sub in group:
                sub["preds"] = preds[off:off + sub["n"]]
                off += sub["n"]
        except BaseException as e:
            for sub in group:
                sub["err"] = e
            if not isinstance(e, Exception):
                raise  # stops the worker: _run marks the batcher failed
        finally:
            for sub in group:
                sub["event"].set()


class Corrector:
    """Spelling-correction engine over a port checkpoint.

    ``device``: None → CUDA (raises without one). ``use_kernels``: None → on
    for CUDA; a config the kernels cannot run raises with the reason unless
    the caller passes ``use_kernels=False``. ``synthetic_vocab``: a seeded
    synthetic vocab of the checkpoint's size with the real vocab's share of
    single CJK chars (``build_synthetic_vocab``). ``native_featurizer``:
    tokenize with the C++ featurizer (``data/native.py``; raises when it
    cannot be built). ``cross_request_batching``: run device steps on a
    worker that merges concurrent requests (:class:`_CrossRequestBatcher`);
    call :meth:`close` to stop it."""

    def __init__(
        self,
        ckpt_dir: str,
        vocab_path: Optional[str] = None,
        batch_size: int = 32,
        use_kernels: Optional[bool] = None,
        fast_path: bool = True,
        synthetic_vocab: bool = False,
        length_buckets: Sequence[int] = (32, 64, 128),
        device=None,
        native_featurizer: bool = False,
        cross_request_batching: bool = False,
    ):
        self.device = resolve_device(device)
        ckpts = list_checkpoints(ckpt_dir)
        ckpt_path = ckpts[-1][1] if ckpts else ckpt_dir
        self.cfg = load_config(ckpt_path)
        dtype = getattr(torch, self.cfg.dtype)
        if use_kernels is None:
            use_kernels = self.device.type == "cuda"
        if use_kernels:
            reason = kernels_unviable_reason(self.cfg, dtype, self.device)
            if reason is not None:
                raise ValueError(
                    f"the fused block kernels cannot serve this checkpoint: "
                    f"{reason}; pass use_kernels=False for the plain path")
        self.use_kernels = use_kernels
        self.batch_size = batch_size

        if vocab_path:
            self.tokenizer = WordPieceTokenizer.from_pretrained(vocab_path)
        elif synthetic_vocab:
            self.tokenizer = WordPieceTokenizer(vocab_to_dict(
                build_synthetic_vocab(size=self.cfg.vocab_size,
                                      cjk_chars=REAL_VOCAB_CJK_CHARS)))
        else:
            raise ValueError("need vocab_path (or synthetic_vocab=True)")
        if len(self.tokenizer) != self.cfg.vocab_size:
            raise ValueError(
                f"tokenizer vocab ({len(self.tokenizer)}) != model vocab "
                f"({self.cfg.vocab_size})")
        self.featurizer = Featurizer(self.tokenizer, self.cfg)
        self.metric = Metric(self.tokenizer)
        self.native = None
        if native_featurizer:
            from realise_tpu_torch.data.native import NativeFeaturizer

            if vocab_path:
                self.native = NativeFeaturizer(
                    vocab_path, do_lower_case=self.tokenizer.basic.do_lower_case)
            else:  # the C++ side reads the vocab file once, when created
                with tempfile.TemporaryDirectory() as tmp:
                    self.native = NativeFeaturizer(
                        self.tokenizer.save_pretrained(tmp),
                        do_lower_case=self.tokenizer.basic.do_lower_case)

        # Built on the meta device: the checkpoint's tensors replace every
        # parameter and buffer, so no init is computed only to be discarded.
        with torch.device("meta"):
            model = Realise(self.cfg)
        model.load_state_dict(load_checkpoint(ckpt_path), assign=True)
        self.model = model.to(self.device).eval()

        self.tables = None
        if fast_path:
            self.tables = precompute_inference_tables(
                self.model, *self.featurizer.pho2_tables())
        self.steps = 0  # device steps run, for callers that count launches

        s_max = self.cfg.max_seq_length
        self._buckets = sorted({min(int(b), s_max)
                                for b in length_buckets} | {s_max})
        # Batch-dim buckets: a single-sentence request computes 1 row, not
        # batch_size rows.
        self._batch_buckets = sorted(
            {1} | {b for b in (8, 16, 32, 64, 128) if b < batch_size}
            | {batch_size})
        self._device_lock = threading.Lock()
        # Guards the batcher's swap in warmup() against close().
        self._batcher_lock = threading.Lock()
        self._closed = False
        self._batcher = (_CrossRequestBatcher(self)
                         if cross_request_batching else None)

    def _bucket_for(self, sentences: Sequence[str]) -> int:
        # +2 for [CLS]/[SEP]; WordPiece can only shrink char counts for CJK.
        need = max((len(s) for s in sentences), default=0) + 2
        for b in self._buckets:
            if need <= b:
                return b
        return self._buckets[-1]

    def _batch_bucket_for(self, n: int) -> int:
        for b in self._batch_buckets:
            if n <= b:
                return b
        return self._batch_buckets[-1]

    def warmup(self, all_buckets: bool = False) -> None:
        """Build and load the kernels and prime the allocator: one small
        request, or with ``all_buckets`` one step of every (batch, length)
        bucket.

        Bypasses the cross-request batcher: live requests arriving during
        warmup (the daemon binds its socket first) would otherwise merge into
        warmup groups and push them to a larger batch bucket, leaving some
        bucket unprimed. A ``close()`` meanwhile is kept: the batcher is then
        closed here instead of put back."""
        with self._batcher_lock:
            batcher, self._batcher = self._batcher, None
        try:
            if all_buckets:
                for b in self._buckets:
                    for n in self._batch_buckets:
                        self.correct_batch(["好" * min(b - 2, 4)] * n,
                                           seq_len=b)
            else:
                self.correct(["好"])
        finally:
            with self._batcher_lock:
                if not self._closed:
                    self._batcher, batcher = batcher, None
            if batcher is not None:
                batcher.close()

    def close(self) -> None:
        """Stop the cross-request batcher's worker (no-op without one); the
        Corrector goes on serving with one serialized step per request."""
        with self._batcher_lock:
            self._closed = True
            batcher, self._batcher = self._batcher, None
        if batcher is not None:
            batcher.close()

    @torch.inference_mode()
    def logits(self, device_arrays: Dict[str, np.ndarray]) -> torch.Tensor:
        """(B, S, V) logits of a featurized device batch."""
        batch = to_device(device_arrays, self.device)
        return self.model(batch, tables=self.tables,
                          use_kernels=self.use_kernels)["logits"]

    def _device_step(self, device_arrays: Dict[str, np.ndarray]) -> np.ndarray:
        """One step over a bucket-shaped batch → (B, S) predicted ids.
        Serialized: request threads interleave featurization and splicing,
        never the device step."""
        with self._device_lock:
            preds = self.logits(device_arrays).argmax(-1).cpu().numpy()
            self.steps += 1
        return preds

    def correct_batch(self, sentences: Sequence[str],
                      seq_len: Optional[int] = None) -> List[str]:
        """One device batch (≤ batch_size sentences) → corrected strings.

        Requests are padded with copies of the last sentence to the smallest
        batch bucket that fits, so a step sees one of a few shapes. With the
        cross-request batcher the padding (and the device call) happens for
        the group instead (:class:`_CrossRequestBatcher`)."""
        n = len(sentences)
        if n == 0:
            return []
        seq = seq_len or self._bucket_for(sentences)
        batcher = self._batcher  # one read: warmup/close may swap it
        host = None
        if batcher is not None:
            host = self.featurizer.featurize_raw(
                list(sentences), native=self.native, seq_len=seq)
            try:
                host["pred_idx"] = batcher.submit(
                    self.featurizer.device_batch(host), n, seq)
            except BatcherClosed:  # close() won the race: serve serialized
                host = None
        if host is None:
            rows = self._batch_bucket_for(n)
            padded = list(sentences) + [sentences[-1]] * (rows - n)
            host = self.featurizer.featurize_raw(padded, native=self.native,
                                                 seq_len=seq)
            host["pred_idx"] = self._device_step(
                self.featurizer.device_batch(host))
        return [self._reconstruct(sentences[i], host, i) for i in range(n)]

    def _reconstruct(self, src: str, host, i) -> str:
        """Splice predicted tokens back into the ORIGINAL sentence.

        Each token maps to its source span (tokenize_with_spans) and only
        clean same-width corrections are substituted, so whitespace, casing
        and un-tokenizable characters of the input survive. Where the span
        tokenization disagrees with the featurizer, the reference's width
        reconstruction (eval/metric.py) is used instead."""
        spans = self.tokenizer.tokenize_with_spans(src)
        length = int(host["lengths"][i])
        pred_ids = np.asarray(host["pred_idx"][i]).tolist()[1 : 1 + length]
        pred_tokens = self.tokenizer.convert_ids_to_tokens(pred_ids)
        if len(spans) != length:
            pred_txt, _ = self.metric.process_batch_item(host, i)
            return pred_txt.split("\t", 1)[1]
        out = list(src)
        unk = self.tokenizer.unk_token
        for (tok, a, b), pred in zip(spans, pred_tokens):
            if pred == tok or pred == unk or tok == unk:
                # tok == unk: the model never saw the original char — keep it.
                continue
            piece = pred[2:] if pred.startswith("##") else pred
            if len(piece) == b - a:
                out[a:b] = piece
            # width mismatch: no faithful per-char mapping — keep the original.
        return "".join(out)

    def correct(self, sentences: Sequence[str]) -> List[str]:
        """Any number of sentences, chunked into device batches."""
        out: List[str] = []
        for start in range(0, len(sentences), self.batch_size):
            out.extend(self.correct_batch(
                sentences[start : start + self.batch_size]))
        return out

    @staticmethod
    def edits(src: str, corrected: str) -> List[Tuple[int, str, str]]:
        """1-based (pos, wrong, correct) diffs."""
        return [(i, a, b)
                for i, (a, b) in enumerate(zip(src, corrected), start=1)
                if a != b]

    def correct_with_edits(self, sentences: Sequence[str]) -> List[Dict]:
        corrected = self.correct(sentences)
        return [{"input": s, "corrected": c,
                 "edits": [{"pos": p, "wrong": w, "correct": r}
                           for p, w, r in self.edits(s, c)]}
                for s, c in zip(sentences, corrected)]
