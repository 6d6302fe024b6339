"""BENCHMARK.json against the contract's shape, and every file it names."""

import json
import os
import re

import pytest
import torch

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = os.path.join(ROOT, "benchmark")


def load():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_paths():
    b = load()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_entry_keys():
    b = load()
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert PATH.match(c["file"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for section in ("end_to_end", "per_layer"):
        for m in b[section]:
            allowed = ({"name", "unit", "better", "bound", "source"}
                       if section == "end_to_end" else
                       {"name", "unit", "better", "source", "layer", "moves"})
            assert set(m) - {"workloads"} == allowed
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert all(NAME.match(n) for n in names), names


def test_unique_names_and_pairs():
    b = load()
    for section in ("configs", "workloads"):
        ns = [x["name"] for x in b[section]]
        assert len(ns) == len(set(ns))
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_sources():
    b = load()
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in b["end_to_end"])


def test_every_cell_has_its_files_and_metrics():
    b = load()
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        assert w["config"] in configs
        for path in (("workloads", w["name"] + ".json"),
                     ("traffic", w["traffic"] + ".json")):
            assert os.path.isfile(os.path.join(BENCH, *path)), path
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
            runner = json.load(f)["runner"]
        assert os.path.isfile(os.path.join(BENCH, "traffic", runner + ".py"))
        e2e = [m for m in b["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert len(e2e) >= 2
        layer = [m for m in b["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert layer and all(m["moves"] in {e["name"] for e in e2e}
                             for m in layer)
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))


# Every configuration publishes these; the file's other shape keys are the
# integer keys that reach the program's parameter shapes.
BACKBONE = ("hidden_size", "num_attention_heads", "intermediate_size",
            "vocab_size", "num_hidden_layers", "max_position_embeddings")
# A width is never cut: a hidden, intermediate, latent, state, projection or
# head size, a key ending in _dim or _rank, the heads (which set the head
# size), an expansion factor, the experts a token takes.
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head)_size$"
                   r"|_dim$|_rank$|^num_attention_heads$|expansion"
                   r"|experts_per_tok")


def param_shapes(cfg):
    from realise_tpu_torch.models.realise import Realise

    from benchmark.traffic.train_stream import program_config

    with torch.device("meta"):
        model = Realise(program_config(cfg))
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def shape_keys(cfg):
    """The backbone's keys, and every integer key of the file whose double
    changes the program's parameter shapes: the stream depths and glyph
    sizes the model uses."""
    base = param_shapes(cfg)
    return set(BACKBONE) | {
        k for k, v in cfg.items() if type(v) is int and k not in BACKBONE
        and param_shapes(dict(cfg, **{k: 2 * v or 1})) != base}


def published_faults(cfg, entry):
    """How a configuration file departs from its ``published`` values and
    its entry in BENCHMARK.json; [] when it holds them."""
    pub, reduced = cfg.get("published", {}), cfg["reduced"]
    faults = []
    if reduced != entry["reduced"]:
        faults.append(f"reduced {reduced} but BENCHMARK.json's "
                      f"{entry['reduced']}")
    faults += [f"{k}: not published"
               for k in sorted(shape_keys(cfg) - set(pub))]
    for k, want in pub.items():
        if k not in cfg:
            faults.append(f"{k}: published, not set")
        elif (cfg[k] != want) != (k in reduced):
            listed = "listed" if k in reduced else "not"
            faults.append(f"{k}: {cfg[k]} against the published {want}, "
                          f"{listed} in reduced")
    for k in reduced:
        if k not in pub:
            faults.append(f"{k}: reduced, not published")
        if WIDTH.search(k):
            faults.append(f"{k}: a width, never reduced")
    return faults


def test_config_files_hold_the_published_widths():
    for c in load()["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert published_faults(cfg, c) == [], c["name"]
        if c["name"] in ("arch3", "bert"):
            # Today's configurations: the published BERT, nothing reduced.
            assert cfg["reduced"] == []
            assert tuple(cfg["published"][k] for k in (
                "hidden_size", "num_attention_heads", "intermediate_size",
                "vocab_size", "num_hidden_layers")) == (
                    768, 12, 3072, 21128, 12)


def other_widths():
    """A configuration of other widths than today's, with its own
    ``published``."""
    with open(os.path.join(BENCH, "configs", "arch3.json")) as f:
        cfg = json.load(f)
    widths = dict(hidden_size=48, num_attention_heads=3, intermediate_size=96,
                  vocab_size=2500)
    cfg.update(widths, published=dict(cfg["published"], **widths))
    return cfg


@pytest.mark.parametrize("changes,entry_reduced,holds", [
    ({}, [], True),
    ({"num_hidden_layers": 4, "reduced": ["num_hidden_layers"]},
     ["num_hidden_layers"], True),
    ({"intermediate_size": 64}, [], False),
    ({"num_hidden_layers": 4}, [], False),
    ({"num_hidden_layers": 4, "reduced": ["num_hidden_layers"]}, [], False),
    ({"intermediate_size": 64, "reduced": ["intermediate_size"]},
     ["intermediate_size"], False),
    ({"reduced": ["pho_num_layers"]}, ["pho_num_layers"], False),
    ({"unpublish": "glyph_size"}, [], False),
], ids=["as_published", "layers_cut_and_listed", "width_changed_unlisted",
        "layers_cut_unlisted", "entry_disagrees", "width_listed",
        "listed_unchanged", "shape_key_unpublished"])
def test_published_width_check_takes_other_widths(changes, entry_reduced,
                                                  holds):
    cfg, changes = other_widths(), dict(changes)
    cfg["published"].pop(changes.pop("unpublish", None), None)
    cfg.update(changes)
    faults = published_faults(cfg, {"reduced": entry_reduced})
    assert (faults == []) is holds, faults


def test_left_out_cells_are_whole():
    """A cell kept out of BENCHMARK.json holds an entry and metrics a later
    change can add there as they are (bounds still to be set)."""
    b = load()
    listed = {w["name"] for w in b["workloads"]}
    for name in os.listdir(os.path.join(BENCH, "workloads")):
        with open(os.path.join(BENCH, "workloads", name)) as f:
            cell = json.load(f)
        assert name == cell["name"] + ".json" and "limits" in cell
        out = cell.get("left_out")
        assert (out is None) == (cell["name"] in listed), name
        if out:
            assert set(out["entry"]) == {"name", "config", "traffic",
                                         "chips", "why"}
            assert out["end_to_end"] and out["per_layer"]
            for m in out["per_layer"]:
                assert os.path.isfile(os.path.join(BENCH, "metrics",
                                                   m["name"] + ".py"))


def test_file_names_are_names():
    for dirpath, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files + dirs:
            rel = os.path.relpath(os.path.join(dirpath, name), ROOT)
            assert PATH.match(rel), rel
