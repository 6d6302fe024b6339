"""One config per wiring of tests/test_torch_presets.py through the port's
CLIs on the CPU, --tiny on the synthetic vocabulary and data: cli/train
with --do_train --do_eval --do_predict, then --resume, cli/test,
cli/correct and cli/serve's daemon. The CLIs take every preset the same
way (it travels in config.json) and tests/test_torch_presets*.py hold each
config's model to the JAX package, so one config per wiring covers them:
bert (no pho or glyph stream, no output block), bert-pho1-res (pho1,
merged), arch2 (concat), arch3-mlm (the MLM head), --fusion sum,
--with_pho no (two streams) and --image_model_type 1 (resnet1). (cli/show_gate is
tests/test_torch_presets_cli.py's.)"""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest

from realise_tpu_torch.config import RealiseConfig
from test_torch_presets import CONFIGS, FLAGS

WIRINGS = ("bert", "bert-pho1-res", "bert-pho2-res-arch2",
           "bert-pho2-res-arch3-mlm", "fusion=sum", "with_pho=no",
           "image_model_type=1")


@pytest.mark.parametrize("name", WIRINGS)
def test_cli_entry_points_run_every_config(name, tmp_path, monkeypatch,
                                           capsys):
    """Each config through the port's CLIs on the CPU, --tiny with one font
    on the synthetic data: cli/train --do_train --do_eval --do_predict (the
    preset and the flags travel in config.json), --resume one step more,
    cli/test, cli/correct, and cli/serve's daemon (port 0, the
    cross-request batcher on) answering one POST."""
    from realise_tpu_torch.cli import correct as tcorrect
    from realise_tpu_torch.cli.serve import serve
    from realise_tpu_torch.serving import Corrector
    from realise_tpu_torch.cli import test as ttest
    from realise_tpu_torch.cli import train as ttrain
    from realise_tpu_torch.cli.common import build_config
    from realise_tpu_torch.training.checkpoint import (list_checkpoints,
                                                       load_config)

    out = tmp_path / "out"
    argv = (["--model_type", CONFIGS[name][0], "--synthetic", "--tiny",
             "--resfonts", "font1", "--device", "cpu", "--output_dir",
             str(out), "--per_device_train_batch_size", "4",
             "--eval_batch_size", "64", "--no_prefetch", "--save_steps", "1"]
            + FLAGS.get(name, []))
    assert ttrain.main(argv + ["--max_steps", "1", "--do_train", "--do_eval",
                               "--do_predict"]) == 0
    assert ttrain.main(argv + ["--max_steps", "2", "--resume"]) == 0
    ckpts = list_checkpoints(str(out))
    assert [s for s, _ in ckpts] == [1, 2]
    want = build_config(ttrain.build_parser().parse_args(argv), 21128)
    for _, path in ckpts:
        assert load_config(path) == RealiseConfig.from_dict(want.to_dict())
    dev = json.loads((out / "dev_results.json").read_text())["1"]
    pred = json.loads((out / "predict_results.json").read_text())
    assert set(dev) == set(pred) and all(
        np.isfinite(v) for v in list(dev.values()) + list(pred.values()))
    assert ttest.main(["--ckpt_dir", str(out), "--synthetic", "--device",
                       "cpu", "--eval_batch_size", "64"]) == 0
    capsys.readouterr()
    monkeypatch.setattr("sys.stdin", io.StringIO("我爱北经。\n天气很好\n"))
    assert tcorrect.main(["--ckpt_dir", str(out), "--synthetic", "--device",
                          "cpu"]) == 0
    assert [len(s) for s in capsys.readouterr().out.splitlines()] == [5, 4]

    corrector = Corrector(str(out), synthetic_vocab=True, device="cpu",
                          cross_request_batching=True)
    server = serve(corrector, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        request = urllib.request.Request(
            f"http://127.0.0.1:{port}/correct", method="POST",
            data=json.dumps({"sentences": ["我爱北经。"]}).encode("utf-8"))
        with urllib.request.urlopen(request, timeout=60) as resp:
            body = json.loads(resp.read().decode("utf-8"))
        assert [len(r["corrected"]) for r in body["results"]] == [5]
    finally:
        server.shutdown()
        server.server_close()
        corrector.close()
        thread.join(timeout=30)
    assert not thread.is_alive()
