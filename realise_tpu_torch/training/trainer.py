"""The training loop: one optimizer step per batch, gradient accumulation.

The port of ``realise_tpu.training.trainer.Trainer``'s step
(``train_step_impl``, trainer.py:90-138) for one device, eager:

* the loss is the masked-CE *sum* and the valid-token *count* of each
  microbatch; gradients of the sums accumulate over the microbatches (the
  batch's rows split in ``grad_accum_steps`` contiguous parts, BatchNorm's
  running statistics updated by each in turn) and are divided once by the
  total count, so accumulation gives the full-batch gradient exactly;
* then the global-norm clip and AdamW with the host-evaluated warmup
  schedule (training/optim.py).

Dropout keys and layer seeds are drawn on the host from the trainer's own
``torch.Generator`` (seeded by ``seed``): the step never waits for the
device. With ``use_kernels`` every encoder layer runs the fused train
kernels (ops/kernels/bert_block_train.py). The streams factorize as the
model routes them (models/realise.py); the conv stream runs over each
microbatch's distinct glyph rows, counted with numpy before the batch goes
to the device (the JAX Trainer's ``_conv_unique_rows``, trainer.py:390-411,
without its static slot budgets, which exist for XLA's static shapes).

Eval (``prepare_eval_tables`` + ``eval_step``, trainer.py:531-592 of the JAX
package, one process) runs the deterministic forward with the (V, H) stream
tables of the current weights and the serving kernels. Not ported yet:
meshes and checkpoints with optimizer state.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.data.features import to_device
from realise_tpu_torch.device import resolve_device
from realise_tpu_torch.models.realise import Realise, precompute_inference_tables
from realise_tpu_torch.ops.kernels import kernels_unviable_reason
from realise_tpu_torch.training.optim import (
    clip_by_global_norm,
    linear_warmup_schedule,
    make_optimizer,
)

logger = logging.getLogger("realise_tpu_torch")


class Trainer:
    """Owns a ``Realise`` model on its device, its AdamW state and the
    dropout generator.

    ``device``: None → CUDA (raises without one). ``use_kernels``: None → on
    for CUDA; a config the kernels cannot run raises with the reason unless
    the caller passes ``use_kernels=False``. ``per_token_streams``: run the
    GRU and conv streams per token slot, the reference path the factorized
    streams are checked and timed against."""

    def __init__(
        self,
        cfg: RealiseConfig,
        model: Realise,
        learning_rate: float = 5e-5,
        warmup_steps: int = 0,
        total_steps: int = 10000,
        weight_decay: float = 0.0,
        adam_epsilon: float = 1e-8,
        max_grad_norm: Optional[float] = 1.0,
        grad_accum_steps: int = 1,
        use_kernels: Optional[bool] = None,
        seed: int = 17,
        device=None,
        per_token_streams: bool = False,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        if use_kernels is None:
            use_kernels = self.device.type == "cuda"
        if use_kernels:
            reason = kernels_unviable_reason(cfg, getattr(torch, cfg.dtype),
                                             self.device)
            if reason is not None:
                raise ValueError(
                    f"the fused train kernels cannot run this config: "
                    f"{reason}; pass use_kernels=False for the plain path")
        if grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got "
                             f"{grad_accum_steps}")
        self.use_kernels = use_kernels
        self.per_token_streams = per_token_streams
        self.grad_accum_steps = grad_accum_steps
        self.max_grad_norm = max_grad_norm
        self.model = model.to(self.device).train()
        self.optimizer = make_optimizer(self.model, learning_rate,
                                        weight_decay, adam_epsilon)
        self.schedule = linear_warmup_schedule(learning_rate, warmup_steps,
                                               total_steps)
        self.generator = torch.Generator().manual_seed(seed)
        self.step = 0
        self._eval_tables: Optional[Dict[str, torch.Tensor]] = None

    def _microbatches(self, batch: Dict[str, Any]):
        """The host batch's rows in ``grad_accum_steps`` contiguous parts,
        each with its distinct glyph rows, on the device."""
        n = self.grad_accum_steps
        rows = len(batch["src_idx"])
        if rows % n:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{n} microbatches")
        size = rows // n
        out = []
        for i in range(n):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            if not self.per_token_streams:
                mb.update(self.model.conv_rows(mb["src_idx"]))
            out.append(to_device(mb, self.device))
        return out

    def train_step(self, device_batch: Dict[str, Any]) -> torch.Tensor:
        """One optimizer step over a featurized host batch (numpy arrays or
        CPU tensors); returns the batch's mean loss as a 0-d device tensor
        (no sync)."""
        self._eval_tables = None  # the weights change
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        span = self.model.span
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=self.device)
        count = torch.zeros((), device=self.device)
        for mb in self._microbatches(device_batch):
            out = self.model(mb, use_kernels=self.use_kernels,
                             generator=self.generator,
                             per_token=self.per_token_streams)
            with span("backward"):
                out["loss_sum"].backward()
            loss_sum += out["loss_sum"].detach()
            count += out["loss_count"].detach()
        with span("clip+adamw"):
            denom = torch.clamp(count, min=1.0)
            grads = []
            for p in self.model.parameters():
                if p.grad is None:  # unused this step: a zero gradient, as in JAX
                    p.grad = torch.zeros_like(p)
                p.grad.div_(denom)
                grads.append(p.grad)
            if self.max_grad_norm is not None:
                clip_by_global_norm(grads, self.max_grad_norm)
            self.optimizer.step()
        self.step += 1
        return loss_sum / denom

    def prepare_eval_tables(self, featurizer) -> None:
        """The (V, H) glyph-feature and GRU tables of the CURRENT weights
        (``precompute_inference_tables``): every later ``eval_step`` gathers
        from them instead of running the conv stack and the GRU. Call again
        after loading other weights; a train step drops them."""
        idx, lens = featurizer.pho2_tables()
        self.model.eval()
        self._eval_tables = precompute_inference_tables(self.model, idx, lens)

    @torch.inference_mode()
    def eval_step(self, device_batch: Dict[str, Any]) -> Dict[str, Any]:
        """The deterministic forward over a featurized host batch →
        {'pred_idx': (B, S) argmax ids, 'loss': the mean loss over its
        loss positions, when it has targets} on the host."""
        batch = to_device(device_batch, self.device)
        self.model.eval()
        out = self.model(batch, tables=self._eval_tables,
                         use_kernels=self.use_kernels)
        res = {"pred_idx": out["logits"].argmax(-1).cpu().numpy()}
        if "loss_sum" in out:
            res["loss"] = float(out["loss_sum"]
                                / torch.clamp(out["loss_count"], min=1.0))
        return res

    def fit(
        self,
        batches: Iterable[Dict[str, np.ndarray]],
        max_steps: Optional[int] = None,
        logging_steps: int = 100,
        save_steps: int = 0,
        save_fn: Optional[Callable[[int, "Trainer"], None]] = None,
        log_fn: Optional[Callable[[Dict[str, Any]], None]] = None,
    ) -> Dict[str, float]:
        """Train over an iterable of host batches; returns summary stats. The
        loss is read back (a device sync) only at logging steps and at the
        end."""
        count = 0
        t0 = time.time()
        loss = None
        last_loss = float("nan")
        for batch in batches:
            loss = self.train_step(batch)
            count += 1
            step = self.step
            if logging_steps and step % logging_steps == 0:
                last_loss = float(loss)
                rec = {"step": step, "loss": last_loss,
                       "lr": self.schedule(step),
                       "steps_per_sec": count / (time.time() - t0)}
                (log_fn or (lambda r: logger.info("%s", r)))(rec)
            if save_steps and save_fn and step % save_steps == 0:
                save_fn(step, self)
            if max_steps is not None and step >= max_steps:
                break
        if loss is not None:
            last_loss = float(loss)
        wall = time.time() - t0
        return {"steps": self.step, "final_loss": last_loss,
                "wall_time_s": wall,
                "steps_per_sec": count / wall if wall > 0 else 0.0}
