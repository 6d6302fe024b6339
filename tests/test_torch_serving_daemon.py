"""The port's cross-request batcher and HTTP daemon (realise_tpu_torch/serving.py
``_CrossRequestBatcher``, ``Corrector.warmup/close``, realise_tpu_torch/cli/serve.py)
against the serial path and the JAX package's daemon, on weights carried
across from the JAX package (the fixture of tests/test_torch_serving.py)."""

import concurrent.futures
import http.client
import json
import os
import sys
import threading
import time

import jax
import numpy as np
import pytest

from realise_tpu.cli import serve as jserve
from realise_tpu.config import config_for
from realise_tpu_torch.cli import serve as tserve
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.serving import Corrector
from torch_port_fixtures import live_glyph_features, live_glyph_rows

SENTENCES = ["我爱北经。", "天气很好", "你好吗？", "好", "再见了 朋友",
             "我爱Ω北京", "hello world好", "這是一個測試", "今天天气很好呀朋友们"]
BUCKETS = (8, 16)  # two length buckets at max_seq_length 16
WAIT = 30.0


@pytest.fixture(scope="module")
def ckpts(small_vocab_list, tmp_path_factory):
    """A tiny arch3 checkpoint written by the JAX package and the same
    weights in the port's format, plus the vocab file."""
    from realise_tpu.models.realise import init_realise
    from realise_tpu.training.checkpoint import load_checkpoint, save_checkpoint
    from realise_tpu_torch.models.convert import state_dict_from_jax
    from realise_tpu_torch.models.realise import Realise
    from realise_tpu_torch.training.checkpoint import save_checkpoint as t_save

    root = tmp_path_factory.mktemp("torch_daemon")
    vocab_path = str(root / "vocab.txt")
    with open(vocab_path, "w", encoding="utf-8") as f:
        f.write("\n".join(small_vocab_list) + "\n")
    cfg = config_for("bert-pho2-res-arch3", vocab_size=len(small_vocab_list),
                     hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                     intermediate_size=32, pho_num_layers=1, out_num_layers=1,
                     max_seq_length=16, max_position_embeddings=32,
                     num_fonts=1)
    rng = np.random.RandomState(0)
    glyphs = (rng.rand(cfg.vocab_size, 1, 32, 32) > 0.5).astype(np.float32)
    params, state = init_realise(jax.random.PRNGKey(0), cfg, glyphs=glyphs)
    params = live_glyph_features(jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.2, np.shape(x)).astype(np.float32),
        params))
    jdir = str(root / "jax")
    save_checkpoint(jdir, 0, params, state, cfg=cfg)
    restored = load_checkpoint(os.path.join(jdir, "saved_ckpt-0"))
    pcfg = RealiseConfig.from_dict(cfg.to_dict())
    tdir = str(root / "port")
    sd = state_dict_from_jax(restored["params"], restored["state"], pcfg)
    t_save(tdir, 0, sd, pcfg)
    model = Realise(pcfg)
    model.load_state_dict(sd)
    assert live_glyph_rows(model) == cfg.vocab_size
    return jdir, tdir, vocab_path


def _corrector(ckpts, **kw):
    _, tdir, vocab_path = ckpts
    return Corrector(tdir, vocab_path=vocab_path, batch_size=4, device="cpu",
                     length_buckets=BUCKETS, **kw)


@pytest.fixture(scope="module")
def serial(ckpts):
    return _corrector(ckpts)


def _run_in_thread(fn, *args):
    """fn(*args) on a thread; returns ('ok', value) or ('err', exception),
    or None when it has not returned within WAIT seconds."""
    out = []

    def target():
        try:
            out.append(("ok", fn(*args)))
        except BaseException as e:  # the test reads what the caller got
            out.append(("err", e))

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(WAIT)
    return out[0] if out else None


@pytest.mark.parametrize("native", [False, True])
def test_batcher_matches_serial(ckpts, serial, native):
    """Concurrent requests through the batcher give exactly the serial
    path's corrections, across sizes and both length buckets, with more
    request threads than cores and a short switch interval; then the same
    requests one at a time (groups of one)."""
    requests = [SENTENCES[i % len(SENTENCES):][:1 + i % 4] for i in range(24)]
    requests += [["今天天气很好呀朋友们", "好"], ["好"], ["我爱北京"]]
    expect = [serial.correct(r) for r in requests]
    assert len({serial._bucket_for(r) for r in requests}) == 2
    batched = _corrector(ckpts, cross_request_batching=True,
                         native_featurizer=native)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=2 * (os.cpu_count() or 4)) as ex:
            futures = [ex.submit(batched.correct, r) for r in requests]
            got = [f.result(timeout=WAIT) for f in futures]
        assert got == expect
        assert batched.steps <= len(requests)
        assert [batched.correct(r) for r in requests] == expect
    finally:
        sys.setswitchinterval(interval)
        batched.close()


def test_groups_share_one_step(ckpts):
    """Stall the device step while submissions pile up: the two stragglers
    ride one group step."""
    c = _corrector(ckpts, cross_request_batching=True)
    inner = c._device_step
    try:
        c.warmup()
        calls, gate = [], threading.Event()

        def slow_step(arrays):
            calls.append(arrays["src_idx"].shape[0])
            gate.wait(WAIT)
            return inner(arrays)

        c._device_step = slow_step
        threads = [threading.Thread(target=c.correct, args=(["好"],))
                   for _ in range(3)]
        threads[0].start()
        deadline = time.time() + WAIT
        while not calls and time.time() < deadline:
            time.sleep(0.001)
        assert calls, "the first request never reached the device step"
        threads[1].start()
        threads[2].start()
        deadline = time.time() + WAIT
        while len(c._batcher._pending) < 2 and time.time() < deadline:
            time.sleep(0.001)
        assert len(c._batcher._pending) == 2
        gate.set()
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
        # One solo step, then ONE step for both stragglers' rows.
        assert calls == [1, c._batch_bucket_for(2)]
    finally:
        c._device_step = inner
        c.close()


def test_oversize_direct_call(ckpts, serial):
    """A direct correct_batch() larger than the device cap rides solo at its
    own row count: no truncation, no stall."""
    c = _corrector(ckpts, cross_request_batching=True)
    try:
        sents = ["我爱北京。", "天气很好", "你好吗", "好", "再见了", "谢谢你"]
        out = c.correct_batch(sents)  # 6 > batch_size 4
        assert out == serial.correct_batch(sents)
    finally:
        c.close()


class Halt(BaseException):
    """Not an Exception: what a KeyboardInterrupt or SystemExit in the
    device step looks like to the batcher."""


def test_a_base_exception_reaches_its_caller_and_stops_the_batcher(
        ckpts, monkeypatch):
    """A device step that raises a BaseException subclass hands it to the
    request; the worker then stops, and a later request raises at once
    instead of waiting on a worker that is gone."""
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    c = _corrector(ckpts, cross_request_batching=True)

    def halt(arrays):
        raise Halt("device step interrupted")

    c._device_step = halt
    try:
        got = _run_in_thread(c.correct, ["好"])
        assert got is not None, "the request never returned"
        assert got[0] == "err" and isinstance(got[1], Halt)
        c._batcher._thread.join(WAIT)
        assert not c._batcher._thread.is_alive()
        later = _run_in_thread(c.correct, ["你好"])
        assert later is not None, "a request after the failure hung"
        assert later[0] == "err" and isinstance(later[1], RuntimeError)
        assert isinstance(later[1].__cause__, Halt)
    finally:
        c.close()


def test_an_exception_reaches_its_group_and_the_batcher_goes_on(ckpts, serial):
    c = _corrector(ckpts, cross_request_batching=True)
    inner = c._device_step
    c._device_step = lambda arrays: (_ for _ in ()).throw(ValueError("bad step"))
    try:
        with pytest.raises(ValueError, match="bad step"):
            c.correct(["好"])
        c._device_step = inner
        assert c.correct(SENTENCES[:3]) == serial.correct(SENTENCES[:3])
    finally:
        c.close()


def test_close_during_warmup_leaves_a_working_corrector(ckpts, serial):
    """close() while warmup() runs: warmup does not put the closed batcher
    back, and later requests take the serialized path."""
    c = _corrector(ckpts, cross_request_batching=True)
    batcher = c._batcher
    inner = c._device_step
    entered, gate = threading.Event(), threading.Event()

    def slow_step(arrays):
        entered.set()
        gate.wait(WAIT)
        return inner(arrays)

    c._device_step = slow_step
    warm = threading.Thread(target=c.warmup, daemon=True)
    warm.start()
    assert entered.wait(WAIT)
    closer = threading.Thread(target=c.close, daemon=True)
    closer.start()
    closer.join(WAIT)
    assert not closer.is_alive()
    gate.set()
    warm.join(WAIT)
    assert not warm.is_alive()
    c._device_step = inner
    assert c._batcher is None
    assert not batcher._thread.is_alive()
    got = _run_in_thread(c.correct, SENTENCES[:3])
    assert got == ("ok", serial.correct(SENTENCES[:3]))


def test_warmup_all_buckets_primes_every_bucket(ckpts):
    c = _corrector(ckpts, cross_request_batching=True)
    try:
        c.warmup(all_buckets=True)
        assert c.steps == len(c._buckets) * len(c._batch_buckets)
        assert c._batcher is not None
    finally:
        c.close()


def _clear_sentences(ckpts):
    """The sentences whose every valid position's top-2 logits (JAX) are
    further apart than the port's logit tolerance, so both packages must
    pick the same token everywhere."""
    from realise_tpu.models.realise import apply_realise, precompute_inference_tables
    from realise_tpu.serving import Corrector as JCorrector

    jdir, _, vocab_path = ckpts
    jc = JCorrector(jdir, vocab_path=vocab_path, batch_size=4)
    host = jc.featurizer.featurize_raw(SENTENCES, seq_len=16)
    arrays = jc.featurizer.device_batch(host)
    idx, lens = jc.featurizer.pho2_tables()
    tables = precompute_inference_tables(jc.params, jc.state, jc.cfg, idx, lens)
    logits = np.asarray(apply_realise(jc.params, jc.state, arrays, jc.cfg,
                                      inference_tables=tables)["logits"])
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2e-4
    valid = arrays["masks"].astype(bool)
    return [s for i, s in enumerate(SENTENCES) if (clear | ~valid)[i].all()]


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.fixture(scope="module")
def servers(ckpts):
    """The port's daemon and the JAX package's, each on a free port (port 0),
    both with cross-request batching."""
    from realise_tpu.serving import Corrector as JCorrector

    jdir, _, vocab_path = ckpts
    correctors = [_corrector(ckpts, cross_request_batching=True),
                  JCorrector(jdir, vocab_path=vocab_path, batch_size=4,
                             cross_request_batching=True)]
    running = []
    for serve, c in zip((tserve.serve, jserve.serve), correctors):
        server = serve(c, "127.0.0.1", 0)
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        running.append((server, t))
    yield [server.server_address[1] for server, _ in running]
    for (server, t), c in zip(running, correctors):
        server.shutdown()
        server.server_close()
        t.join(WAIT)
        c.close()


def test_http_correct_matches_the_jax_daemon(ckpts, servers):
    port, jax_port = servers
    sentences = _clear_sentences(ckpts)
    assert len(sentences) >= len(SENTENCES) // 2
    bodies = [sentences, sentences[:1], sentences[1:3], sentences[::-1]]
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
        ours = list(ex.map(lambda b: _http(port, "POST", "/correct",
                                           json.dumps({"sentences": b})),
                           bodies))
    theirs = [_http(jax_port, "POST", "/correct", json.dumps({"sentences": b}))
              for b in bodies]
    assert ours == theirs
    assert all(status == 200 for status, _ in ours)
    assert _http(port, "GET", "/healthz") == _http(jax_port, "GET", "/healthz")


@pytest.mark.parametrize("method, path, body, status", [
    ("POST", "/correct", "{not json", 400),
    ("POST", "/correct", json.dumps({"sentences": "我爱北京"}), 400),
    ("POST", "/correct", json.dumps({"sentences": ["好", 3]}), 400),
    ("POST", "/correct", json.dumps(["好"]), 400),
    ("POST", "/nowhere", json.dumps({"sentences": ["好"]}), 404),
    ("GET", "/nowhere", None, 404),
])
def test_http_errors_match_the_jax_daemon(servers, method, path, body, status):
    port, jax_port = servers
    got = _http(port, method, path, body)
    assert got == _http(jax_port, method, path, body)
    assert got[0] == status


def test_serve_flags_match_the_jax_daemon():
    """The JAX daemon's flags, with --device and --no_kernels in place of
    --platform and --use_pallas/--no_pallas."""
    ours = set(vars(tserve.build_parser().parse_args(["--ckpt_dir", "x"])))
    theirs = set(vars(jserve.build_parser().parse_args(["--ckpt_dir", "x"])))
    assert ours - theirs == {"device", "no_kernels"}
    assert theirs - ours == {"platform", "use_pallas"}


def test_cuda_entry_points_leave_bf16_sums_alone(monkeypatch):
    """An entry point on CUDA turns TF32 off and leaves cuBLAS's bfloat16
    reduction setting as the caller's process has it: the served rows' batch
    invariance rests on ``gate_fusion``'s float32 product-sum, not on a
    process-wide flag."""
    import torch

    from realise_tpu_torch.device import resolve_device

    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    monkeypatch.setattr(matmul, "allow_tf32", True)
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for setting in (True, False):
        monkeypatch.setattr(matmul, "allow_bf16_reduced_precision_reduction",
                            setting)
        assert resolve_device("cuda").type == "cuda"
        assert matmul.allow_bf16_reduced_precision_reduction is setting
    assert not matmul.allow_tf32 and not cudnn.allow_tf32
