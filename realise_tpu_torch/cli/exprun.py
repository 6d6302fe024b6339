"""Experiment grid generator of the port: ``realise_tpu.cli.exprun`` (the
exprun.py equivalent). It runs on the host only: it writes scripts and
touches no device.

Expands a parameter grid into per-experiment run scripts (reference:
exprun.py:5-48, which expands a YAML grid into per-SKU cluster scripts).
Config is YAML or JSON:

    command: |
      python -m realise_tpu_torch.cli.train --model_type {model_type} \
          --learning_rate {lr} --seed {seed} --output_dir {__name__}
    params:
      - name: model_type
        values: [bert, bert-pho2-res-arch3]
      - name: lr
        values: [5e-5, 3e-5]
      - name: seed
        values: [17]
    target_dir: experiments

Writes ``{target_dir}/{combo-name}/run.sh`` for the full cartesian product
(the reference's copy-pasted subset-expansion loop is replaced by
itertools.product) plus a ``manifest.json`` of all combos.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import stat
from typing import Dict, List


def load_spec(path: str) -> Dict:
    with open(path, encoding="utf-8") as f:
        text = f.read()
    spec = None
    errors = []
    try:
        import yaml  # type: ignore

        spec = yaml.safe_load(text)
    except ImportError:
        pass
    except Exception as e:  # yaml installed but file isn't yaml: try json
        errors.append(f"yaml: {e}")
    if spec is None:
        try:
            spec = json.loads(text)
        except Exception as e:
            errors.append(f"json: {e}")
    if not isinstance(spec, dict):
        raise SystemExit(
            f"{path}: could not parse an experiment spec ("
            + ("; ".join(errors) or "empty document") + ")")
    for key in ("params", "command"):
        if key not in spec:
            raise SystemExit(
                f"{path}: experiment spec is missing required key "
                f"{key!r} (has: {sorted(spec)})")
    if not isinstance(spec["params"], list) or not all(
            isinstance(p, dict) and "name" in p and "values" in p
            for p in spec["params"]):
        raise SystemExit(
            f"{path}: 'params' must be a list of "
            "{{name: ..., values: [...]}} entries")
    return spec


def expand_grid(spec: Dict) -> List[Dict[str, object]]:
    names = [p["name"] for p in spec["params"]]
    values = [p["values"] for p in spec["params"]]
    combos = []
    for combo in itertools.product(*values):
        combos.append(dict(zip(names, combo)))
    return combos


def combo_name(combo: Dict[str, object]) -> str:
    return "_".join(f"{k}-{v}" for k, v in combo.items())


def generate(spec: Dict, target_dir: str) -> List[str]:
    command = spec["command"]
    written = []
    manifest = []
    for combo in expand_grid(spec):
        name = combo_name(combo)
        exp_dir = os.path.join(target_dir, name)
        os.makedirs(exp_dir, exist_ok=True)
        script = command
        for k, v in combo.items():
            script = script.replace("{" + k + "}", str(v))
        script = script.replace("{__name__}", exp_dir)
        run_file = os.path.join(exp_dir, "run.sh")
        with open(run_file, "w", encoding="utf-8") as f:
            f.write("#!/bin/bash\nset -e\n\n" + script + "\n")
        os.chmod(run_file, os.stat(run_file).st_mode | stat.S_IXUSR)
        written.append(run_file)
        manifest.append({"name": name, "params": combo, "script": run_file})
    with open(os.path.join(target_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True, help="YAML/JSON grid spec")
    parser.add_argument("--target_dir", default=None,
                        help="override spec's target_dir")
    args = parser.parse_args(argv)
    spec = load_spec(args.config)
    target = args.target_dir or spec.get("target_dir", "experiments")
    written = generate(spec, target)
    print(f"wrote {len(written)} run scripts under {target}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
