"""Checkpoint-merge CLI of the port: ``realise_tpu.cli.merge`` (the merge.py
equivalent).

Overlays a pho2-pretrain and a res-pretrain checkpoint on a base fine-tuning
checkpoint (an arch3 init, say) and writes ``saved_ckpt-0`` under
``--output_dir``, with the base's config and ``merged_from`` in its
``training_args.json``; ``cli/train --init_ckpt`` starts fine-tuning from it
(reference: merge.py:5-38). Each of the three flags takes a checkpoint dir
or a run dir (its latest ``saved_ckpt-*``). The merge runs on CUDA unless
``--device`` says otherwise; it keeps every tensor's bits
(``training/merge.merge_state_dicts``).

Example:
    python -m realise_tpu_torch.cli.merge --base_ckpt base/saved_ckpt-0 \
        --pho_ckpt pho --res_ckpt res --output_dir merged --device cpu
"""

from __future__ import annotations

import argparse

from realise_tpu_torch.cli.common import logger, setup_logging


def _resolve(path: str) -> str:
    """A run dir's latest ``saved_ckpt-*``, or the checkpoint dir itself."""
    from realise_tpu_torch.training.checkpoint import list_checkpoints

    ckpts = list_checkpoints(path)
    return ckpts[-1][1] if ckpts else path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--base_ckpt", required=True,
                   help="base fine-tuning checkpoint (e.g. an arch3 init)")
    p.add_argument("--pho_ckpt", default=None)
    p.add_argument("--res_ckpt", default=None)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run on the CPU)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging()
    from realise_tpu_torch.device import resolve_device
    from realise_tpu_torch.training.checkpoint import (
        load_checkpoint,
        load_config,
        save_checkpoint,
    )
    from realise_tpu_torch.training.merge import merge_state_dicts

    device = resolve_device(args.device)  # raises without CUDA by default
    base_dir = _resolve(args.base_ckpt)
    cfg = load_config(base_dir)
    pho = (load_checkpoint(_resolve(args.pho_ckpt), map_location=device)
           if args.pho_ckpt else None)
    res = (load_checkpoint(_resolve(args.res_ckpt), map_location=device)
           if args.res_ckpt else None)
    merged = merge_state_dicts(load_checkpoint(base_dir, map_location=device),
                               pho=pho, res=res)
    out = save_checkpoint(args.output_dir, 0, merged, cfg, training_args={
        "merged_from": {"base": base_dir, "pho": args.pho_ckpt,
                        "res": args.res_ckpt}})
    logger.info("merged checkpoint written to %s", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
