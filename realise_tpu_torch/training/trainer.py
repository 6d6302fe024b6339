"""The training loop: one optimizer step per batch, gradient accumulation.

The port of ``realise_tpu.training.trainer.Trainer``'s step
(``train_step_impl``, trainer.py:90-138) for one device, eager:

* the loss is the masked-CE *sum* and the valid-token *count* of each
  microbatch; gradients of the sums accumulate over the microbatches (the
  batch's rows split in ``grad_accum_steps`` contiguous parts, BatchNorm's
  running statistics updated by each in turn) and are divided once by the
  total count, so accumulation gives the full-batch gradient exactly;
* then the global-norm clip and AdamW with the host-evaluated warmup
  schedule (training/optim.py): on CUDA two kernels, the norm and then the
  update, which divides and clips each gradient as it reads it and leaves
  ``p.grad`` the step's sum; on the CPU the division and the clip in place
  and ``torch.optim.AdamW``.

Dropout keys and layer seeds are drawn on the host from the trainer's own
``torch.Generator`` (seeded by ``seed``): the step never waits for the
device. With ``use_kernels`` every encoder layer runs the fused train
kernels (ops/kernels/bert_block_train.py). The step is the same for every
preset: the streams factorize as the model routes them (models/realise.py),
the GRU only in the pho2 presets, the conv in every preset with a glyph
stream, the merged and the resnet1 ones too; the conv stream runs over each
microbatch's distinct glyph rows, counted with numpy before the batch goes
to the device (the JAX Trainer's ``_conv_unique_rows``, trainer.py:390-411,
without its static slot budgets, which exist for XLA's static shapes).

Eval (``prepare_eval_tables`` + ``eval_step``, trainer.py:531-592 of the JAX
package, one process) runs the deterministic forward with the (V, H) stream
tables of the current weights and the serving kernels.

The pretraining stages (a ``RealisePretrain``, the JAX Trainer's
``pretrain=True``, trainer.py:233-236,278-343,542) take the same step and
accumulation: ``res-pretrain``'s (N,) ``char_idx`` batches split into
microbatches as the (B, S) ones do. Their eval runs the live streams (they
have no (V, H) tables), the conv over the batch's own glyph rows, and
returns the loss whenever the batch has labels (``char_idx`` always
does).

:meth:`Trainer.state_dict` holds what a resume needs beside the weights: the
optimizer's state, the step and the dropout generator's state. The JAX step
folds the step into its dropout key (trainer.py:135), so a JAX resume
replays the same masks by construction; here the layer seeds come from a
stateful generator, which must be restored for a resumed run to train on
the masks of the run it continues.

Data parallelism (``mesh`` without a ``model`` axis; the JAX Trainer's
shard_map step, ``train_step_shard``, trainer.py:167-243): one process per
card, each
holding the whole model and running the kernels on its own contiguous
slice of the global batch, as that step's body runs on each device's
shard. Each rank accumulates its loss sums, valid-token counts and
gradients of the sums over its microbatches as above; then one all-reduce
SUM per fixed-order bucket (every rank reduces the same tensors in the same
order: a parameter without a gradient gets its zero one first) gives every
rank the global sums, which are divided by the global count, so the clip
and AdamW see the global-batch gradient on every rank. BatchNorm's batch
statistics stay per rank, and its running statistics are averaged over the
ranks after the step (the ``pmean`` of trainer.py:190-196). Every rank
draws the same layer seeds and keys from one generator, moved to the
rank's stream (``ops/layers.StreamGenerator``): rank 0 draws what a run
without a group draws, and rank 0's ``trainer.pt`` restores every rank.
``eval_step`` runs this rank's rows and gathers the predictions of every
rank in rank order; its loss is the global sum over the global count. The
(V, H) eval tables are built on every rank. Overlapping the all-reduce
with the backward is not done.

Tensor parallelism (``mesh`` with a ``model`` axis above 1; the JAX
Trainer's GSPMD step, trainer.py:133-138 with ``param_shardings``,
:374-384): the Trainer splits the model over the axis
(``parallel/tensor.shard_module``), so the encoder layers run Megatron's
column and row products on the plain path (the kernels need the whole
hidden dim: ``use_kernels=None`` resolves to off and says why, ``True``
raises). The sums above are all-reduced over the rank's data group only
(the ranks of its model index; the world would count each replica
``model`` times), and so are the eval's gather and sums. The conjugate
operators make the replicated parameters' gradients equal on a model
group's ranks, so they need no model all-reduce; the clip sums the split
gradients' squares over the model group (``optim.clip_by_global_norm``; on
CUDA their chunks' partial sums, between the two kernels), and AdamW steps
the local slices, so its moments are split like their parameters. The
step is then the GSPMD one, the one-process step on the global batch, and
not the shard_map one: every rank draws stream 0 (one
key), each dropout site indexes its mask by the element's place in the
global array, and the BatchNorm statistics are the global batch's. The
glyph stream gets that from ``Realise.conv_rows`` over the data group: the
data ranks all-reduce each microbatch's glyph-row counts and each runs the
conv over the union of their rows with the global counts, the one forward
of every data rank, so the gradient all-reduce sums the global gradient
and the running statistics are the same on every rank with no averaging. With
``grad_accum_steps`` a microbatch is the union of every data rank's
contiguous part of its rows (the GSPMD step cuts the global batch into
contiguous parts instead, which differs only where BatchNorm sees the
partition). ``model_state_dict`` and ``state_dict`` gather the full
tensors (the AdamW moments too) over the model group, and loading slices
them again: a checkpoint holds the unsplit weights whatever the mesh. A
model with nothing to split (``res-pretrain``) trains as on the data axis
alone, each model rank a copy.

Spans: the loop brackets every phase through the model's span hook
(``Realise.span``, default ``no_span``, read where each span opens; a
``utils/profiler.SpanRecorder`` times them): ``fit`` the wait for each
batch ('input') and the logging and saving steps ('log', 'save');
``train_step`` the learning-rate set, ``model.train()`` and ``zero_grad``
('prep'), the split, the glyph-row count and the copies to the device
('upload'), the forward (the model's spans), 'backward' (the encoder's
'encoder.attn_bwd' and 'encoder.ffn_bwd' inside it on the kernel path),
the release of the last microbatch's autograd graph and the unused
parameters' zero gradients ('grads'), 'all-reduce', 'clip+adamw' and, on a
data axis alone, 'running-stats'. Between one batch and the next only
single statements run outside them (with ``grad_accum_steps`` above 1, an
earlier microbatch's graph is released where the next one's output takes
its name).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.data.features import to_device
from realise_tpu_torch.device import resolve_device
from realise_tpu_torch.models.realise import (
    RealisePretrain,
    precompute_inference_tables,
)
from realise_tpu_torch.ops.kernels import kernels_unviable_reason
from realise_tpu_torch.ops.layers import dropout_generator
from realise_tpu_torch.parallel.distributed import gather_rows
from realise_tpu_torch.parallel.mesh import param_shardings
from realise_tpu_torch.parallel.tensor import (
    gather_state_dict,
    gather_tensor,
    mesh_groups,
    shard_module,
    shard_tensor,
)
from realise_tpu_torch.training.optim import (
    clip_by_global_norm,
    linear_warmup_schedule,
    make_optimizer,
)

logger = logging.getLogger("realise_tpu_torch")

# Elements of one all-reduce bucket (float32: 64 MB).
BUCKET_ELEMENTS = 1 << 24


class Trainer:
    """Owns a ``Realise`` or ``RealisePretrain`` model on its device, its
    AdamW state and the dropout generator.

    ``device``: None → CUDA (raises without one). ``use_kernels``: None → on
    for CUDA; a config the kernels cannot run raises with the reason unless
    the caller passes ``use_kernels=False``. ``per_token_streams``: run the
    GRU and conv streams per token slot, the reference path the factorized
    streams are checked and timed against. ``mesh``: a ``parallel.Mesh``
    over the initialized process group, or the ``MeshGroups`` of one;
    default every rank of the group on ``data``, none without a group (one
    process)."""

    def __init__(
        self,
        cfg: RealiseConfig,
        model: nn.Module,
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
        mesh=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        groups = self.groups = mesh_groups(mesh)
        self.tensor_parallel = groups is not None and any(
            d is not None for d in param_shardings(
                model.named_parameters(), groups.mesh).values())
        if self.tensor_parallel:
            if use_kernels:
                raise ValueError(
                    f"mesh {groups.mesh}: a model axis above 1 runs the "
                    f"plain sub-blocks (the fused train kernels need the "
                    f"whole hidden dim); pass use_kernels=False or None")
            if use_kernels is None:
                logger.info("kernels off under mesh %s: the tensor-parallel "
                            "layers run the plain sub-blocks (the fused "
                            "kernels need the whole hidden dim)", groups.mesh)
            use_kernels = False
        self.data_index = 0 if groups is None else groups.data_index
        self.data_size = 1 if groups is None else groups.mesh.data
        self.data_group = None if groups is None else groups.data_group
        if self.tensor_parallel and per_token_streams and self.data_size > 1:
            raise ValueError("per-token streams under a data×model mesh "
                             "would take BatchNorm statistics per data rank; "
                             "the tensor-parallel step runs the factorized "
                             "streams")
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
        self.pretrain = isinstance(model, RealisePretrain)
        self.grad_accum_steps = grad_accum_steps
        self.max_grad_norm = max_grad_norm
        self.splits = (shard_module(model, groups) if self.tensor_parallel
                       else {})
        self.model = model.to(self.device).train()
        self.optimizer = make_optimizer(
            self.model, learning_rate, weight_decay, adam_epsilon,
            split=[p for n, p in self.model.named_parameters()
                   if n in self.splits])
        names = {id(p): n for n, p in self.model.named_parameters()}
        # The optimizer state's indices, by name: its groups' order.
        self._opt_names = [names[id(p)] for g in self.optimizer.param_groups
                           for p in g["params"]]
        self._split_mask = [n in self.splits
                            for n, _ in self.model.named_parameters()]
        self.schedule = linear_warmup_schedule(learning_rate, warmup_steps,
                                               total_steps)
        self.generator = dropout_generator(
            seed, 0 if self.tensor_parallel else self.data_index)
        self.step = 0
        self._eval_tables: Optional[Dict[str, torch.Tensor]] = None

    def _microbatches(self, batch: Dict[str, Any]):
        """The host batch's rows in ``grad_accum_steps`` contiguous parts,
        each with its distinct glyph rows, on the device."""
        n = self.grad_accum_steps
        rows = len(batch["src_idx" if "src_idx" in batch else "char_idx"])
        if rows % n:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{n} microbatches")
        size = rows // n
        # Under a data×model mesh the conv runs over the data ranks' rows
        # with their summed counts: the global batch's BatchNorm statistics.
        group = (self.data_group if self.tensor_parallel
                 and self.data_size > 1 else None)
        out = []
        for i in range(n):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            if not self.per_token_streams and "src_idx" in mb:
                mb.update(self.model.conv_rows(mb["src_idx"], group))
            out.append(to_device(mb, self.device))
        return out

    def train_step(self, device_batch: Dict[str, Any]) -> torch.Tensor:
        """One optimizer step over a featurized host batch (numpy arrays or
        CPU tensors); returns the batch's mean loss as a 0-d device tensor
        (no sync)."""
        self._eval_tables = None  # the weights change
        span = self.model.span
        with span("prep"):
            lr = self.schedule(self.step)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.model.train()
            self.optimizer.zero_grad(set_to_none=True)
            loss_sum = torch.zeros((), device=self.device)
            count = torch.zeros((), device=self.device)
        with span("upload"):
            microbatches = self._microbatches(device_batch)
        for mb in microbatches:
            out = self.model(mb, use_kernels=self.use_kernels,
                             generator=self.generator,
                             per_token=self.per_token_streams)
            with span("backward"):
                out["loss_sum"].backward()
            loss_sum += out["loss_sum"].detach()
            count += out["loss_count"].detach()
        with span("grads"):
            # The last microbatch's autograd graph is released here, inside
            # a span, and not at the return: freeing its nodes is host work
            # that grows with the model's layers.
            del out
            grads = []
            for p in self.model.parameters():
                if p.grad is None:  # unused this step: a zero one, as in JAX
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
        if self.data_group is not None:
            with span("all-reduce"):
                self.all_reduce_sum([loss_sum, count] + grads)
        with span("clip+adamw"):
            model_group = (self.groups.model_group if self.tensor_parallel
                           else None)
            if self.optimizer.runs_kernels:
                # Two kernels: the norm, then the update, which divides and
                # clips each gradient as it reads it (they stay the sums).
                self.optimizer.clip(count, self.max_grad_norm, model_group)
            else:
                denom = torch.clamp(count, min=1.0)
                for g in grads:
                    g.div_(denom)
                if self.max_grad_norm is not None:
                    clip_by_global_norm(grads, self.max_grad_norm,
                                        self._split_mask, model_group)
            self.optimizer.step()
        if self.data_group is not None and not self.tensor_parallel:
            with span("running-stats"):
                self._average_running_stats()
        self.step += 1
        return loss_sum / torch.clamp(count, min=1.0)

    def all_reduce_sum(self, tensors) -> None:
        """Sum each tensor over the ranks, in place: flattened into buckets of
        at most ``BUCKET_ELEMENTS`` in list order (one dtype a bucket), one
        all-reduce each. The same list on every rank reduces the same
        buckets, and a bucket's sum is one fixed-order reduction, so two
        runs give equal bits."""
        bucket, size = [], 0

        def flush():
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                            group=self.data_group)
            offset = 0
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()

        for t in tensors:
            if bucket and (size + t.numel() > BUCKET_ELEMENTS
                           or t.dtype != bucket[0].dtype):
                flush()
                bucket, size = [], 0
            bucket.append(t)
            size += t.numel()
        if bucket:
            flush()

    def _average_running_stats(self) -> None:
        """BatchNorm's running statistics, the mean over the data ranks."""
        stats = [b for name, b in self.model.named_buffers()
                 if name.endswith(("running_mean", "running_var"))]
        if stats:
            with torch.no_grad():
                self.all_reduce_sum(stats)
                for b in stats:
                    b.div_(self.data_size)

    def model_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with its full, unsplit tensors (gathered
        over the model group under tensor parallelism: every rank of the
        group must call it): what a checkpoint's ``model.pt`` holds."""
        state = self.model.state_dict()
        if not self.splits:
            return state
        return gather_state_dict(state, self.splits, self.groups.model_group)

    def _moments(self, opt_state: Dict[str, Any], part) -> Dict[str, Any]:
        """``opt_state`` (an optimizer ``state_dict()``) with each split
        parameter's moment tensors passed through ``part(tensor, dim,
        name)``, in new dicts (the optimizer's own hold its live state)."""
        out = dict(opt_state, state=dict(opt_state["state"]))
        for i, st in opt_state["state"].items():
            name = self._opt_names[i]
            dim = self.splits.get(name)
            if dim is not None:
                out["state"][i] = {
                    k: part(v, dim, name) if k.startswith("exp_avg") else v
                    for k, v in st.items()}
        return out

    def state_dict(self) -> Dict[str, Any]:
        """The optimizer's state, the step and the dropout generator's state
        (the model's weights are saved apart, :meth:`model_state_dict`).
        Under tensor parallelism the AdamW moments of the split parameters
        are gathered over the model group into their full tensors."""
        opt = self.optimizer.state_dict()
        if self.splits:
            group = self.groups.model_group
            opt = self._moments(opt,
                                lambda t, d, _: gather_tensor(t, d, group))
        return {"optimizer": opt, "step": self.step,
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore :meth:`state_dict`, whatever mesh wrote it: a split
        parameter's full moments are sliced to this rank's part. AdamW
        casts its moments to each parameter's device and dtype; the params
        are float32, so the moments come back exactly."""
        opt = state["optimizer"]
        if self.splits:
            index, count = self.groups.model_index, self.groups.mesh.model

            def part(t, dim, name):
                local = self.model.get_parameter(name)
                return (t if t.shape == local.shape
                        else shard_tensor(t, dim, index, count))

            opt = self._moments(opt, part)
        self.optimizer.load_state_dict(opt)
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])

    def prepare_eval_tables(self, featurizer) -> None:
        """The (V, H) glyph-feature and GRU tables of the CURRENT weights, as
        the preset has them
        (``precompute_inference_tables``): every later ``eval_step`` gathers
        from them instead of running the conv stack and the GRU. Call again
        after loading other weights; a train step drops them. The
        pretraining stages have none: their eval runs the live streams."""
        self.model.eval()
        if self.pretrain:
            self._eval_tables = None
            return
        self._eval_tables = precompute_inference_tables(
            self.model, *featurizer.pho2_tables())

    @torch.inference_mode()
    def eval_step(self, device_batch: Dict[str, Any]) -> Dict[str, Any]:
        """The deterministic forward over a featurized host batch →
        {'pred_idx': (B, S) argmax ids ((N,) for ``char_idx``), 'loss': the
        mean loss over its loss positions, when it has targets} on the
        host. In a process group the batch is this rank's rows: every rank
        gets the predictions of all ranks' rows in rank order, and the loss
        is their global sum over their global count."""
        self.model.eval()
        if self.pretrain:
            batch = dict(device_batch)
            if "src_idx" in batch:
                batch.update(self.model.conv_rows(batch["src_idx"]))
            out = self.model(to_device(batch, self.device),
                             use_kernels=self.use_kernels)
        else:
            out = self.model(to_device(device_batch, self.device),
                             tables=self._eval_tables,
                             use_kernels=self.use_kernels)
        pred = out["logits"].argmax(-1)
        if self.data_group is not None:
            pred = gather_rows(pred, self.data_group)
        res = {"pred_idx": pred.cpu().numpy()}
        if "loss_sum" in out:
            sums = [out["loss_sum"].float().clone(),
                    out["loss_count"].float().clone()]
            if self.data_group is not None:
                self.all_reduce_sum(sums)
            res["loss"] = float(sums[0] / torch.clamp(sums[1], min=1.0))
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
        end.

        ``dispatch`` holds the percentiles of each ``train_step``'s time on
        the host clock after two warm-up steps (``StepTimer(warmup=2)``, as
        the JAX ``fit``). On CUDA it is the host's time to issue a step,
        with no added sync; but a step's batch goes to the card by blocking
        copies (``to_device``), which first wait for the card to finish the
        work already queued. So a step's dispatch time also holds what the
        card had left of the step before: it reads the device's step time
        where the card is the bound, and more where the host is. No batch
        is held back between calls: a second ``fit`` on the same stream
        starts at the next batch."""
        from realise_tpu_torch.utils.profiler import StepTimer

        timer = StepTimer(warmup=2)
        count = 0
        t0 = time.time()
        loss = None
        last_loss = float("nan")
        batches = iter(batches)
        # A run that has reached max_steps (a resumed one) takes no batch.
        while max_steps is None or self.step < max_steps:
            with self.model.span("input"):
                batch = next(batches, None)
            if batch is None:
                break
            with timer:
                loss = self.train_step(batch)
            count += 1
            step = self.step
            if logging_steps and step % logging_steps == 0:
                with self.model.span("log"):
                    last_loss = float(loss)
                    rec = {"step": step, "loss": last_loss,
                           "lr": self.schedule(step),
                           "steps_per_sec": count / (time.time() - t0)}
                    (log_fn or (lambda r: logger.info("%s", r)))(rec)
            if save_steps and save_fn and step % save_steps == 0:
                with self.model.span("save"):
                    save_fn(step, self)
        if loss is not None:
            last_loss = float(loss)
        wall = time.time() - t0
        return {"steps": self.step, "final_loss": last_loss,
                "wall_time_s": wall,
                "steps_per_sec": count / wall if wall > 0 else 0.0,
                "dispatch": timer.summary()}
