"""Gate introspection CLI of the port — ``realise_tpu.cli.show_gate`` (the
src/show_gate.py equivalent) over the port's checkpoints.

Writes the per-token selective-modality gate values of a gate-fusion
checkpoint (arch3, arch4 and their ablations) over a dataset to a TSV:
columns id, pos, char, then one gate per stream in the model's order,
g_sem, g_pho (when the model has a pho stream), g_res (when it has a glyph
stream). The model returns its gates (``return_gates``); the forward is the
serving one, with the (V, H) stream tables and, on CUDA, the fused block
kernels. Runs on CUDA unless told otherwise.

Example:
    python -m realise_tpu_torch.cli.show_gate --ckpt_dir /tmp/out \
        --synthetic --output gate.tsv --device cpu
"""

from __future__ import annotations

import argparse

import torch

from realise_tpu_torch.cli.common import (
    build_tokenizer,
    load_dataset,
    logger,
    setup_logging,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--data_dir", default=None)
    p.add_argument("--vocab_path", default=None)
    p.add_argument("--test_file", default=None)
    p.add_argument("--output", default="gate.tsv")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run on the CPU)")
    p.add_argument("--no_kernels", action="store_true",
                   help="plain PyTorch sub-blocks instead of the fused kernels")
    return p


def stream_names(cfg) -> list:
    """The gate columns in the model's stream order (ablated models have
    two streams)."""
    return (["g_sem"] + (["g_pho"] if cfg.with_pho else [])
            + (["g_res"] if cfg.with_res else []))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging()
    from realise_tpu_torch.data.dataset import batch_iterator, pad_examples
    from realise_tpu_torch.data.features import Featurizer, to_device
    from realise_tpu_torch.device import resolve_device
    from realise_tpu_torch.models.realise import (
        Realise,
        precompute_inference_tables,
    )
    from realise_tpu_torch.ops.kernels import kernels_unviable_reason
    from realise_tpu_torch.training.checkpoint import (
        list_checkpoints,
        load_checkpoint,
        load_config,
    )

    device = resolve_device(args.device)  # raises without CUDA by default
    ckpts = list_checkpoints(args.ckpt_dir)
    ckpt_path = ckpts[-1][1] if ckpts else args.ckpt_dir
    cfg = load_config(ckpt_path)
    if cfg.fusion not in ("gate", "softmax_gate"):
        raise SystemExit(f"model {cfg.model_type} has no gate fusion")
    use_kernels = device.type == "cuda" and not args.no_kernels
    if use_kernels:
        reason = kernels_unviable_reason(cfg, getattr(torch, cfg.dtype), device)
        if reason is not None:
            raise SystemExit(f"the fused block kernels cannot run this "
                             f"checkpoint: {reason}; pass --no_kernels")
    with torch.device("meta"):
        model = Realise(cfg)
    model.load_state_dict(load_checkpoint(ckpt_path), assign=True)
    model = model.to(device).eval()

    tokenizer = build_tokenizer(args)
    if len(tokenizer) != cfg.vocab_size:
        raise SystemExit(f"tokenizer vocab ({len(tokenizer)}) != model vocab "
                         f"({cfg.vocab_size}): pass the matching --vocab_path")
    featurizer = Featurizer(tokenizer, cfg)
    tables = precompute_inference_tables(model,
                                         *featurizer.pho2_tables())
    data = load_dataset(args, tokenizer, args.test_file, num_synthetic=32,
                        seed=5)
    names = stream_names(cfg)

    rows = []
    # Unpadded iteration (the real example count); the step takes the batch
    # padded to batch_size and only the real rows are written.
    for examples in batch_iterator(data, args.batch_size, pad_final=False):
        host = featurizer.featurize(pad_examples(examples, args.batch_size))
        with torch.inference_mode():
            gates = model(to_device(featurizer.device_batch(host), device),
                          tables=tables, use_kernels=use_kernels,
                          return_gates=True)["gates"]
        gates = gates.float().cpu().numpy()
        for i, ex in enumerate(examples):
            # Truncated examples keep their untruncated `lengths`; only S-2
            # content positions exist.
            length = min(ex["lengths"], host["src_idx"].shape[1] - 2)
            for pos in range(1, length + 1):
                char = tokenizer.convert_ids_to_tokens(
                    [int(host["src_idx"][i, pos])])[0]
                vals = "\t".join(f"{g:.4f}" for g in gates[i, pos, :len(names)])
                rows.append(f"{ex['id']}\t{pos}\t{char}\t{vals}")

    with open(args.output, "w", encoding="utf-8") as f:
        f.write("id\tpos\tchar\t" + "\t".join(names) + "\n")
        f.write("\n".join(rows) + "\n")
    logger.info("wrote %d gate rows to %s", len(rows), args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
