"""Serving in the PyTorch port (``debias_vision_lang_torch/serve``) against
the JAX package's ``serve``, on the CPU at the JAX suite's tiny size
(tests/test_serve.py: a DebiasCLIP 32 px, patch 16, width 32, 2 layers).

The same weights (JAX's seeded init, carried into the port by
``models/convert.py::params_from_jax``) and the same numpy inputs go
through both packages.  Bars: float32 embeddings within atol 1e-4;
bfloat16 and int8 at cosine >= 0.999 (the bars of test_torch_models.py and
test_torch_quant.py); host decode and preprocessing bit-exact; ``score`` of
the same embeddings within 1e-6; over HTTP the same status code and error
string for every request of the JAX suite's HTTP cases.  The micro-batcher
(the port's copy) runs the JAX suite's batcher cases, parametrised over
both classes.  The ``cuda``-marked tests run the engine on the card.
"""

import base64
import http.client
import io
import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from debias_vision_lang_tpu import serve as jserve
from debias_vision_lang_tpu.core.config import (CLIPConfig, DebiasConfig,
                                                TextConfig, VisionConfig)
from debias_vision_lang_tpu.models.clip import init_clip_params
from debias_vision_lang_tpu.models.debias import DebiasCLIP as JDebiasCLIP
from debias_vision_lang_tpu.models.debias import init_debias_tokens
from debias_vision_lang_tpu.serve import engine as jengine_mod
from debias_vision_lang_tpu.text.tokenizer import ClipTokenizer as JTok
from debias_vision_lang_torch import serve as tserve
from debias_vision_lang_torch.models.clip import CLIP
from debias_vision_lang_torch.models.convert import params_from_jax
from debias_vision_lang_torch.models.debias import DebiasCLIP as TDebiasCLIP
from debias_vision_lang_torch.serve import engine as tengine_mod
from debias_vision_lang_torch.serve import server as tserver_mod
from debias_vision_lang_torch.text.tokenizer import ClipTokenizer as TTok
from debias_vision_lang_torch.vision.preprocess import patchify_u8, preprocess_batch
from torch_port_config import port_config

torch.set_num_threads(1)

N_PX = 32
CTX = 16
MERGES = [("t", "h"), ("th", "e</w>")]
F32_ATOL = 1e-4
COS_MIN = 0.999
BATCHERS = [jserve.MicroBatcher, tserve.MicroBatcher]
BATCHER_IDS = ["jax", "port"]


def _cfg(vocab):
    return CLIPConfig(
        name="tiny-serve",
        vision=VisionConfig(kind="vit", image_size=N_PX, patch_size=16,
                            width=32, layers=2, heads=2, embed_dim=16),
        text=TextConfig(vocab_size=vocab, context_length=CTX,
                        width=32, layers=2, heads=2, embed_dim=16))


@pytest.fixture(scope="module")
def models():
    """(JAX DebiasCLIP, port DebiasCLIP on the CPU) with the same weights:
    the JAX suite's serving model (tests/test_serve.py:22-43)."""
    jtok = JTok(MERGES, context_length=CTX)
    cfg = _cfg(jtok.vocab_size)
    params = init_clip_params(jax.random.key(0), cfg)
    dcfg = DebiasConfig(num_debias_tokens=2, hidden_dim=32, max_tokens=CTX)
    deb = init_debias_tokens(jax.random.key(1), params, dcfg, tokenizer=None)
    jmodel = JDebiasCLIP(clip_params=params, debias_tokens=deb, clip_cfg=cfg,
                         debias_cfg=dcfg)
    clip = CLIP(port_config(cfg))
    clip.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                         port_config(cfg)))
    tmodel = TDebiasCLIP(clip, torch.from_numpy(np.array(deb)), port_config(dcfg))
    return jmodel, tmodel


def _engines(models, compute_dtype=None, max_batch=8):
    jmodel, tmodel = models
    return (jserve.InferenceEngine(jmodel, JTok(MERGES, context_length=CTX),
                                   max_batch=max_batch, compute_dtype=compute_dtype),
            tserve.InferenceEngine(tmodel, TTok(MERGES, context_length=CTX),
                                   max_batch=max_batch, compute_dtype=compute_dtype,
                                   device="cpu"))


@pytest.fixture(scope="module")
def engines(models):
    return _engines(models)


def _frames(rng, n):
    return [rng.integers(0, 256, (N_PX, N_PX, 3), dtype=np.uint8) for _ in range(n)]


def _jpeg_bytes(rng, h=48, w=40):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
        buf, format="JPEG", quality=92)
    return buf.getvalue()


def _png_bytes(rng, h=20, w=30):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _min_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                       * np.linalg.norm(b, axis=-1))).min())


# ---------------------------------------------------------------------------
# The micro-batcher: the JAX suite's cases on both classes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batcher_cls", BATCHERS, ids=BATCHER_IDS)
class TestMicroBatcher:
    def test_order_and_results(self, batcher_cls):
        calls = []

        def run(items):
            calls.append(len(items))
            return [x * 2 for x in items]

        mb = batcher_cls(run, max_batch=4, max_wait_ms=20)
        futs = [mb.submit(i) for i in range(10)]
        assert [f.result(timeout=5) for f in futs] == [2 * i for i in range(10)]
        mb.close()
        assert sum(calls) == 10 and max(calls) <= 4

    def test_coalescing(self, batcher_cls):
        calls = []

        def run(items):
            calls.append(len(items))
            return items

        mb = batcher_cls(run, max_batch=16, max_wait_ms=200)
        futs = []
        barrier = threading.Barrier(6)

        def client(i):
            barrier.wait()
            futs.append(mb.submit(i))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        for f in list(futs):
            f.result(timeout=5)
        mb.close()
        assert max(calls) > 1

    def test_exception_propagates_per_batch(self, batcher_cls):
        def run(items):
            raise RuntimeError("boom")

        mb = batcher_cls(run, max_batch=4, max_wait_ms=5)
        with pytest.raises(RuntimeError, match="boom"):
            mb.submit(1).result(timeout=5)
        mb.close()

    def test_wrong_result_count_is_an_error(self, batcher_cls):
        mb = batcher_cls(lambda items: items[:-1] if len(items) > 1 else [],
                         max_batch=4, max_wait_ms=5)
        with pytest.raises(RuntimeError, match="returned"):
            mb.submit(1).result(timeout=5)
        mb.close()

    def test_close_drains(self, batcher_cls):
        mb = batcher_cls(lambda items: items, max_batch=4, max_wait_ms=5)
        futs = [mb.submit(i) for i in range(3)]
        mb.close()
        assert [f.result(timeout=1) for f in futs] == [0, 1, 2]
        with pytest.raises(RuntimeError, match="closed"):
            mb.submit(9)

    def test_two_stage_results_and_order(self, batcher_cls):
        def dispatch(items):
            return np.asarray(items + [0] * (4 - len(items)))

        mb = batcher_cls(dispatch, finalize=lambda h, n: h[:n] * 10, max_batch=4,
                 max_wait_ms=10)
        futs = [mb.submit(i) for i in range(9)]
        assert [int(f.result(timeout=5)) for f in futs] == [10 * i for i in range(9)]
        mb.close()
        assert mb.stats["items"] == 9

    def test_finalize_exception_propagates(self, batcher_cls):
        def finalize(handle, n):
            raise ValueError("fetch died")

        mb = batcher_cls(lambda items: items, finalize=finalize, max_batch=4, max_wait_ms=5)
        with pytest.raises(ValueError, match="fetch died"):
            mb.submit(1).result(timeout=5)
        mb.close()

    def test_close_drains_pipeline(self, batcher_cls):
        mb = batcher_cls(lambda items: np.asarray(items), finalize=lambda h, n: h[:n],
                 max_batch=2, max_wait_ms=5)
        futs = [mb.submit(i) for i in range(5)]
        mb.close()
        assert [int(f.result(timeout=1)) for f in futs] == list(range(5))

    def test_cancelled_future_does_not_kill_worker(self, batcher_cls):
        gate = threading.Event()

        def run_batch(items):
            gate.wait(timeout=5)
            return [x * 2 for x in items]

        b = batcher_cls(run_batch, max_batch=4, max_wait_ms=1.0)
        try:
            f1 = b.submit(1)
            time.sleep(0.05)
            f2 = b.submit(2)
            assert f2.cancel()
            gate.set()
            assert f1.result(timeout=5) == 2
            assert b.submit(3).result(timeout=5) == 6
        finally:
            gate.set()
            b.close()


def test_batcher_stress_counts_every_item():
    """More submitting threads than cores, a short switch interval: every
    future resolves to its own item and the counters add up."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    mb = tserve.MicroBatcher(lambda items: np.asarray(items),
                             finalize=lambda h, n: h[:n] + 1,
                             max_batch=8, max_wait_ms=1)
    results = {}
    try:
        def client(k):
            futs = [(i, mb.submit(k * 100 + i)) for i in range(50)]
            results[k] = [(k * 100 + i, int(f.result(timeout=10))) for i, f in futs]

        threads = [threading.Thread(target=client, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        mb.close()
    assert all(got == want + 1 for rows in results.values() for want, got in rows)
    assert mb.stats["items"] == 16 * 50 and mb.stats["batches"] < 16 * 50


# ---------------------------------------------------------------------------
# Host decode and preprocessing: bit-exact against the JAX engine's
# ---------------------------------------------------------------------------


class TestHostDecode:
    @pytest.mark.parametrize("kind", ["jpeg", "png", "jpeg-wide"])
    def test_decode_image_bytes_bit_exact(self, kind):
        rng = np.random.default_rng(3)
        data = {"jpeg": lambda: _jpeg_bytes(rng), "png": lambda: _png_bytes(rng),
                "jpeg-wide": lambda: _jpeg_bytes(rng, 40, 120)}[kind]()
        got = tserve.decode_image_bytes(data)
        np.testing.assert_array_equal(got, jserve.decode_image_bytes(data))
        assert got.dtype == np.uint8 and got.ndim == 3

    def test_decode_cap_enforced(self, monkeypatch):
        data = _jpeg_bytes(np.random.default_rng(0))
        monkeypatch.setattr(tengine_mod, "MAX_DECODE_PIXELS", 100)
        monkeypatch.setattr(jengine_mod, "MAX_DECODE_PIXELS", 100)
        with pytest.raises(ValueError, match="decode limit") as t_err:
            tserve.decode_image_bytes(data)
        with pytest.raises(ValueError) as j_err:
            jserve.decode_image_bytes(data)
        assert str(t_err.value) == str(j_err.value)

    @pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["hwc", "staged"])
    def test_prepare_images_batch_bit_exact(self, models, dtype):
        je, te = _engines(models, dtype)
        rng = np.random.default_rng(4)
        records = [_jpeg_bytes(rng), _jpeg_bytes(rng, 96, 64), _png_bytes(rng),
                   _jpeg_bytes(rng, 40, 120)]
        got, want = te.prepare_images_batch(records), je.prepare_images_batch(records)
        for g, w, rec in zip(got, want, records):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(te.prepare_image(rec), je.prepare_image(rec))

    def test_prepare_images_batch_errors_as_jax(self, engines, monkeypatch):
        je, te = engines
        rng = np.random.default_rng(5)
        bad = [_jpeg_bytes(rng), b"not an image"]
        errs = []
        for e in (je, te):
            with pytest.raises(ValueError, match="undecodable") as err:
                e.prepare_images_batch(bad)
            errs.append(re.sub(r"0x[0-9a-f]+", "0x", str(err.value)))
        assert errs[0] == errs[1]
        monkeypatch.setattr(tengine_mod, "MAX_DECODE_PIXELS", 100)
        with pytest.raises(ValueError, match="oversized|exceeds"):
            te.prepare_images_batch([_jpeg_bytes(rng)])


# ---------------------------------------------------------------------------
# The engine against the JAX engine
# ---------------------------------------------------------------------------


class TestEngine:
    def test_float32_embeddings(self, engines):
        je, te = engines
        rng = np.random.default_rng(0)
        imgs = _frames(rng, 5)
        assert te.compute_dtype == torch.float32 and te._patch is None
        np.testing.assert_allclose(te.embed_image_arrays(imgs),
                                   je.embed_image_arrays(imgs), atol=F32_ATOL, rtol=0)
        texts = ["the", "the the", "a b c", "tthe"]
        np.testing.assert_array_equal(te.tokenize(texts), je.tokenize(texts))
        np.testing.assert_allclose(te.embed_token_arrays(list(te.tokenize(texts))),
                                   je.embed_token_arrays(list(je.tokenize(texts))),
                                   atol=F32_ATOL, rtol=0)

    @pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int8-text"])
    def test_reduced_precision_embeddings(self, models, dtype):
        je, te = _engines(models, dtype)
        assert te.info()["precision"] == je.info()["precision"] == dtype
        assert te._patch == je._patch == 16
        rng = np.random.default_rng(1)
        imgs = _frames(rng, 5)
        assert _min_cos(te.embed_image_arrays(imgs), je.embed_image_arrays(imgs)) >= COS_MIN
        toks = list(je.tokenize(["the", "the the", "a b c"]))
        assert _min_cos(te.embed_token_arrays(toks), je.embed_token_arrays(toks)) >= COS_MIN

    def test_score_same_embeddings(self, engines):
        je, te = engines
        rng = np.random.default_rng(2)
        img = te.embed_image_arrays(_frames(rng, 2))
        txt = te.embed_token_arrays(list(te.tokenize(["the", "a", "b c"])))
        assert te._score_scale == je._score_scale
        probs = te.score(img, txt)
        np.testing.assert_allclose(probs, je.score(img, txt), atol=1e-6, rtol=0)
        np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)

    def test_bucket_padding_matches_direct(self, engines):
        _, te = engines
        imgs = _frames(np.random.default_rng(6), 3)  # pads to bucket 4
        out = te.embed_image_arrays(imgs)
        with torch.no_grad():
            x = preprocess_batch(torch.from_numpy(np.stack(imgs)), N_PX)
            direct = te.model.encode_image(x, dtype=torch.float32).float().numpy()
        np.testing.assert_allclose(out, direct, rtol=1e-5, atol=1e-6)

    def test_staged_bucket_rows_equal_direct(self, models):
        """bf16: every row of a padded bucket equals the row of a direct
        encode_image call on the same staged uint8 bucket."""
        _, te = _engines(models, "bfloat16")
        frames = _frames(np.random.default_rng(7), 3)
        out = te.embed_image_arrays(frames)
        staged = np.zeros((4, 4, 16 * 16 * 3), np.uint8)
        staged[:3] = patchify_u8(np.stack(frames), 16)
        with torch.no_grad():
            direct = te.model.encode_image(torch.from_numpy(staged),
                                           dtype=torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(out, direct[:3])

    def test_staged_and_hwc_inputs_equal(self, models):
        _, te = _engines(models, "bfloat16")
        frames = _frames(np.random.default_rng(8), 4)
        staged = list(patchify_u8(np.stack(frames), 16))
        mixed = [frames[0], staged[1], frames[2], staged[3]]
        ref = te.embed_image_arrays(frames)
        np.testing.assert_array_equal(ref, te.embed_image_arrays(staged))
        np.testing.assert_array_equal(ref, te.embed_image_arrays(mixed))

    def test_oversize_input_chunks(self, engines):
        je, te = engines
        imgs = _frames(np.random.default_rng(9), te.max_batch * 2 + 3)
        out = te.embed_image_arrays(imgs)
        assert out.shape == (len(imgs), 16)
        per_chunk = np.concatenate([te.embed_image_arrays(imgs[:te.max_batch]),
                                    te.embed_image_arrays(imgs[te.max_batch:])])
        np.testing.assert_allclose(out, per_chunk, rtol=1e-6)
        np.testing.assert_allclose(out, je.embed_image_arrays(imgs), atol=F32_ATOL, rtol=0)

    def test_dispatch_rejects_oversize_as_jax(self, engines):
        errs = []
        imgs = _frames(np.random.default_rng(10), 9)
        for e in engines:
            with pytest.raises(ValueError, match="exceeds max_batch") as err:
                e.dispatch_image_arrays(imgs)
            errs.append(str(err.value))
        assert errs[0] == errs[1]

    def test_wrong_image_shape_rejected_as_jax(self, engines):
        errs = []
        for e in engines:
            with pytest.raises(ValueError, match="expected") as err:
                e.embed_image_arrays([np.zeros((8, 8, 3), np.uint8)])
            errs.append(str(err.value))
        assert errs[0] == errs[1]

    def test_empty_input(self, engines):
        for e in engines:
            assert e.embed_image_arrays([]).shape == (0, 16)
            assert e.embed_token_arrays([]).shape == (0, 16)

    def test_non_pow2_max_batch_normalized(self, models):
        je, te = _engines(models, max_batch=6)
        assert te.max_batch == je.max_batch == 8

    def test_warmup_runs_every_bucket(self, engines):
        _, te = engines
        seen = []
        te.warmup(log=seen.append)
        assert seen == [f"warmup: bucket {b}" for b in (1, 2, 4, 8)]

    def test_info_has_the_jax_keys(self, engines):
        je, te = engines
        info = te.info()
        assert set(je.info()) <= set(info)
        assert info["backend"] == "cpu" and info["mesh"] is None
        assert info["device_memory"] is None
        for k in ("model", "n_px", "embed_dim", "context_length", "compute_dtype",
                  "max_batch", "has_tokenizer"):
            assert info[k] == je.info()[k], k

    def test_no_tokenizer_raises_as_jax(self, models):
        errs = []
        for e in (jserve.InferenceEngine(models[0], None),
                  tserve.InferenceEngine(models[1], None, device="cpu")):
            with pytest.raises(RuntimeError, match="tokenizer") as err:
                e.tokenize(["the"])
            errs.append(str(err.value))
        assert errs[0] == errs[1]

    def test_mesh_refused_naming_the_roadmap_item(self, models):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 5"):
            tserve.InferenceEngine(models[1], None, mesh=object(), device="cpu")

    def test_auto_dtype_refused_naming_the_roadmap_item(self, models):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 8"):
            tserve.InferenceEngine(models[1], None, compute_dtype="auto", device="cpu")

    def test_unknown_dtype_refused(self, models):
        with pytest.raises(ValueError, match="unknown dtype"):
            tserve.InferenceEngine(models[1], None, compute_dtype="fp8", device="cpu")

    def test_default_device_without_a_card_raises(self, models, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.InferenceEngine(models[1])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.serve_forever(models[1], port=0)


# ---------------------------------------------------------------------------
# HTTP: the JAX and the port servers, sent the same requests
# ---------------------------------------------------------------------------


def _start(app, **kw):
    httpd = (jserve.make_server if isinstance(app, jserve.ServeApp)
             else tserve.make_server)(app, port=0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd, app):
    httpd.shutdown()
    httpd.server_close()
    app.close()


@pytest.fixture(scope="module")
def servers(engines):
    """{"jax": base url, "port": base url}; both float32 engines."""
    je, te = engines
    apps = {"jax": jserve.ServeApp(je, max_wait_ms=2.0),
            "port": tserve.ServeApp(te, max_wait_ms=2.0)}
    started = {k: _start(a) for k, a in apps.items()}
    yield {k: base for k, (_, base) in started.items()}
    for k, (httpd, _) in started.items():
        _stop(httpd, apps[k])


def _request(url, body=None, headers=None, method=None):
    req = urllib.request.Request(url, data=body, headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _json_body(obj):
    return json.dumps(obj).encode(), {"Content-Type": "application/json"}


RAW = {"Content-Type": "application/octet-stream"}


def _cases():
    """(id, path, body, headers) for every POST of the JAX suite's HTTP
    tests (tests/test_serve.py:289-592) and its fuzz list."""
    rng = np.random.default_rng(11)
    jb = _jpeg_bytes(rng)
    b64 = base64.b64encode(jb).decode()
    frames = rng.integers(0, 256, (3, N_PX, N_PX, 3), dtype=np.uint8)
    big = bytearray(_jpeg_bytes(rng))
    i = big.find(b"\xff\xc0")
    big[i + 5:i + 7] = (65500).to_bytes(2, "big")
    big[i + 7:i + 9] = (65500).to_bytes(2, "big")
    corrupt = b"\xff\xd8notactuallyajpeg" * 3
    n_cap = tserver_mod.MAX_ITEMS_PER_REQUEST + 1
    cases = [
        ("text", "/v1/embed/text", *_json_body({"texts": ["the", "the the"]})),
        ("image", "/v1/embed/image", *_json_body({"images_b64": [b64]})),
        ("score", "/v1/score", *_json_body({"image_b64": b64, "texts": ["the", "the the"]})),
        ("no-route", "/v1/nope", *_json_body({})),
        ("empty-texts", "/v1/embed/text", *_json_body({"texts": []})),
        ("images-not-list", "/v1/embed/image", *_json_body({"images_b64": "x"})),
        ("overlong-text", "/v1/embed/text", *_json_body({"texts": ["the " * 100]})),
        ("undecodable", "/v1/embed/image",
         *_json_body({"images_b64": [base64.b64encode(b"notanimage").decode()]})),
        ("raw-u8", "/v1/embed/image-raw", frames.tobytes(), {**RAW, "X-Image-Format": "u8"}),
        ("raw-u8-one", "/v1/embed/image-raw", frames[0].tobytes(),
         {**RAW, "X-Image-Format": "u8"}),
        ("raw-jpeg", "/v1/embed/image-raw", len(jb).to_bytes(4, "big") + jb,
         {**RAW, "X-Image-Format": "jpeg"}),
        ("raw-jpeg-two", "/v1/embed/image-raw", (len(jb).to_bytes(4, "big") + jb) * 2,
         {**RAW, "X-Image-Format": "jpeg"}),
        ("raw-json", "/v1/embed/image-raw", frames[1].tobytes(),
         {**RAW, "X-Image-Format": "u8", "Accept": "application/json"}),
        ("raw-bad-size", "/v1/embed/image-raw", b"\x00" * 17, {**RAW, "X-Image-Format": "u8"}),
        ("raw-bad-format", "/v1/embed/image-raw", b"\x00" * 4,
         {**RAW, "X-Image-Format": "png"}),
        ("raw-truncated", "/v1/embed/image-raw", (1000).to_bytes(4, "big") + b"xx",
         {**RAW, "X-Image-Format": "jpeg"}),
        ("image-non-string", "/v1/embed/image", *_json_body({"images_b64": [42]})),
        ("text-non-string", "/v1/embed/text", *_json_body({"texts": [42]})),
        ("image-cap", "/v1/embed/image", *_json_body({"images_b64": [b64] * n_cap})),
        ("jpeg-cap", "/v1/embed/image-raw", (len(jb).to_bytes(4, "big") + jb) * n_cap,
         {**RAW, "X-Image-Format": "jpeg"}),
        ("oversized-dims", "/v1/embed/image",
         *_json_body({"images_b64": [base64.b64encode(bytes(big)).decode()]})),
        ("raw-corrupt-jpeg", "/v1/embed/image-raw",
         len(corrupt).to_bytes(4, "big") + corrupt, {**RAW, "X-Image-Format": "jpeg"}),
        ("garbage-json", "/v1/embed/image", b"\x00\xff" * 37,
         {"Content-Type": "application/json"}),
        ("bad-b64", "/v1/embed/image", b'{"images_b64": ["%%%not-b64%%%"]}',
         {"Content-Type": "application/json"}),
        ("null-text", "/v1/embed/text", b'{"texts": [null]}',
         {"Content-Type": "application/json"}),
        ("json-array", "/v1/embed/text", b"[1, 2, 3]", {"Content-Type": "application/json"}),
        ("score-no-image", "/v1/score", b'{"texts": ["a"]}',
         {"Content-Type": "application/json"}),
        ("raw-u8-7", "/v1/embed/image-raw", b"\x00" * 7, {**RAW, "X-Image-Format": "u8"}),
        ("raw-absurd-length", "/v1/embed/image-raw", b"\xff\xff\xff\xff",
         {**RAW, "X-Image-Format": "jpeg"}),
        ("raw-tiff", "/v1/embed/image-raw", b"x", {**RAW, "X-Image-Format": "tiff"}),
        ("no-route-json", "/v1/nonexistent", b"{}", {"Content-Type": "application/json"}),
    ]
    for k in range(10):
        cases.append((f"fuzz-{k}", "/v1/embed/image", rng.bytes(int(rng.integers(1, 300))),
                      {"Content-Type": "application/json"}))
    return cases


CASES = _cases()


def _error(body: bytes) -> str:
    """A response's error string, with object addresses masked (PIL names
    the BytesIO it failed on)."""
    return re.sub(r"0x[0-9a-f]+", "0x", json.loads(body)["error"])


def _embeddings(status, headers, body):
    if headers.get("Content-Type") == "application/octet-stream":
        n, d = int(headers["X-Count"]), int(headers["X-Dim"])
        return np.frombuffer(body, "<f4").reshape(n, d)
    out = json.loads(body)
    return np.asarray(out["embeddings"] if "embeddings" in out else out["probs"])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_http_request_answered_as_jax(servers, case):
    _, path, body, headers = case
    got = {k: _request(base + path, body, headers) for k, base in servers.items()}
    (j_status, j_headers, j_body), (t_status, t_headers, t_body) = got["jax"], got["port"]
    assert t_status == j_status, (t_status, t_body[:200], j_body[:200])
    if j_status != 200:
        assert 400 <= t_status < 500
        assert _error(t_body) == _error(j_body)
        return
    assert t_headers.get("Content-Type") == j_headers.get("Content-Type")
    t_emb, j_emb = _embeddings(t_status, t_headers, t_body), _embeddings(
        j_status, j_headers, j_body)
    assert t_emb.shape == j_emb.shape and np.isfinite(t_emb).all()
    np.testing.assert_allclose(t_emb, j_emb, atol=F32_ATOL, rtol=0)


def test_http_healthz(servers):
    infos = {}
    for k, base in servers.items():
        status, _, body = _request(base + "/healthz")
        assert status == 200
        infos[k] = json.loads(body)
    for key in ("status", "model", "n_px", "embed_dim", "context_length", "max_batch"):
        assert infos["port"][key] == infos["jax"][key], key
    assert infos["port"]["backend"] == "cpu"
    assert infos["port"]["image_batches"]["batches"] >= 0


def test_http_raw_jpeg_equals_b64(servers):
    rng = np.random.default_rng(12)
    jb = _jpeg_bytes(rng)
    base = servers["port"]
    _, h, raw = _request(base + "/v1/embed/image-raw", len(jb).to_bytes(4, "big") + jb,
                         {**RAW, "X-Image-Format": "jpeg"})
    _, _, js = _request(base + "/v1/embed/image",
                        *_json_body({"images_b64": [base64.b64encode(jb).decode()]}))
    np.testing.assert_allclose(_embeddings(200, h, raw),
                               np.asarray(json.loads(js)["embeddings"]), atol=1e-5)


def _host_port(base):
    host, port = base.replace("http://", "").split(":")
    return host, int(port)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_http_bad_content_length_400(servers, which):
    conn = http.client.HTTPConnection(*_host_port(servers[which]), timeout=30)
    try:
        conn.putrequest("POST", "/v1/embed/image-raw", skip_accept_encoding=True)
        conn.putheader("Content-Type", "application/octet-stream")
        conn.putheader("X-Image-Format", "u8")
        conn.putheader("Content-Length", "abc")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400
        assert json.loads(resp.read())["error"] == "bad Content-Length header"
    finally:
        conn.close()


@pytest.mark.parametrize("which", ["jax", "port"])
def test_http_body_size_cap_413(servers, which):
    req = urllib.request.Request(
        servers[which] + "/v1/embed/text", data=b"{}",
        headers={"Content-Type": "application/json",
                 "Content-Length": str(tserver_mod.MAX_BODY_BYTES + 1)})
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=10)
    assert exc.value.code == 413
    assert json.loads(exc.value.read())["error"] == (
        f"body of {tserver_mod.MAX_BODY_BYTES + 1} bytes exceeds the "
        f"{tserver_mod.MAX_BODY_BYTES}-byte limit")


def test_http_keepalive_and_get_with_body(servers):
    conn = http.client.HTTPConnection(*_host_port(servers["port"]), timeout=30)
    try:
        for body in (None, None, b"x" * 120, None):
            conn.request("GET", "/healthz", body=body)
            resp = conn.getresponse()
            assert resp.status == 200
            json.loads(resp.read())
    finally:
        conn.close()


def test_http_stats_time_device_work(servers):
    b64 = base64.b64encode(_jpeg_bytes(np.random.default_rng(13))).decode()
    status, _, _ = _request(servers["port"] + "/v1/embed/image",
                            *_json_body({"images_b64": [b64]}))
    assert status == 200
    _, _, body = _request(servers["port"] + "/healthz")
    stats = json.loads(body)["image_batches"]
    assert stats["batches"] >= 1 and stats["run_seconds"] > 0


def test_http_concurrent_clients_coalesce(engines):
    """Concurrent single-text requests: the answers equal the serial ones
    and the batcher formed fewer batches than requests."""
    _, te = engines
    app = tserve.ServeApp(te, max_wait_ms=200.0)
    httpd, base = _start(app)
    try:
        texts = [f"the{'!' * i}" for i in range(6)]
        results = [None] * 6
        barrier = threading.Barrier(6)

        def client(i):
            barrier.wait()
            _, _, body = _request(base + "/v1/embed/text", *_json_body({"texts": [texts[i]]}))
            results[i] = np.asarray(json.loads(body)["embeddings"])[0]

        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        stats = app._texts.stats
        assert stats["items"] == 6 and stats["batches"] < 6, stats
        _, _, serial = _request(base + "/v1/embed/text", *_json_body({"texts": texts}))
        np.testing.assert_allclose(np.stack(results),
                                   np.asarray(json.loads(serial)["embeddings"]),
                                   rtol=1e-4, atol=1e-5)
    finally:
        _stop(httpd, app)


def test_http_burst_of_32_clients_all_answered(engines):
    """32 single-frame clients at once: every connection is accepted (the
    port's listen backlog; the stdlib's 5 lets the kernel reset the rest)
    and the batcher coalesces them."""
    _, te = engines
    assert tserver_mod.LISTEN_BACKLOG >= 32
    app = tserve.ServeApp(te, max_wait_ms=50.0)
    httpd, base = _start(app)
    frames = np.random.default_rng(14).integers(0, 256, (32, N_PX, N_PX, 3), dtype=np.uint8)
    results = [None] * 32
    barrier = threading.Barrier(32)

    def client(i):
        barrier.wait()
        results[i] = _request(base + "/v1/embed/image-raw", frames[i].tobytes(),
                              {**RAW, "X-Image-Format": "u8"})

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert [r[0] for r in results] == [200] * 32
        got = np.stack([np.frombuffer(r[2], "<f4") for r in results])
        np.testing.assert_allclose(got, te.embed_image_arrays(list(frames)), rtol=1e-5,
                                   atol=1e-6)
        stats = app._images.stats
        assert stats["items"] == 32 and stats["batches"] < 32, stats
    finally:
        _stop(httpd, app)


class TestAuthTLS:
    @pytest.fixture(scope="class")
    def auth_servers(self, engines):
        apps = {"jax": jserve.ServeApp(engines[0], max_wait_ms=2.0),
                "port": tserve.ServeApp(engines[1], max_wait_ms=2.0)}
        started = {k: _start(a, auth_token="sekrit-42") for k, a in apps.items()}
        yield {k: base for k, (_, base) in started.items()}
        for k, (httpd, _) in started.items():
            _stop(httpd, apps[k])

    @pytest.mark.parametrize("token", [None, "wrong", "caf\xe9", "sekrit-42"])
    def test_bearer_token(self, auth_servers, token):
        got = {}
        for k, base in auth_servers.items():
            body, headers = _json_body({"texts": ["the"]})
            if token is not None:
                headers["Authorization"] = f"Bearer {token}"
            status, _, out = _request(base + "/v1/embed/text", body, headers)
            got[k] = (status, json.loads(out).get("error"))
        assert got["port"] == got["jax"]
        assert got["port"][0] == (200 if token == "sekrit-42" else 401)

    def test_healthz_minimal_without_token(self, auth_servers):
        base = auth_servers["port"]
        _, _, body = _request(base + "/healthz")
        assert json.loads(body) == {"status": "ok"}
        _, _, body = _request(base + "/healthz",
                              headers={"Authorization": "Bearer sekrit-42"})
        full = json.loads(body)
        assert "model" in full and "image_batches" in full

    def test_env_token_default(self, engines, monkeypatch):
        monkeypatch.setenv("DVL_SERVE_TOKEN", "env-tok")
        app = tserve.ServeApp(engines[1], max_wait_ms=2.0)
        httpd, base = _start(app)
        try:
            body, headers = _json_body({"texts": ["the"]})
            assert _request(base + "/v1/embed/text", body, headers)[0] == 401
            headers["Authorization"] = "Bearer env-tok"
            assert _request(base + "/v1/embed/text", body, headers)[0] == 200
        finally:
            _stop(httpd, app)

    def test_tls_termination(self, engines, tmp_path):
        import ssl
        import subprocess

        cert = tmp_path / "cert.pem"
        try:
            subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout",
                            str(cert), "-out", str(cert), "-days", "1", "-nodes",
                            "-subj", "/CN=localhost"],
                           check=True, capture_output=True, timeout=60)
        except (FileNotFoundError, subprocess.CalledProcessError):
            pytest.skip("openssl unavailable")
        app = tserve.ServeApp(engines[1], max_wait_ms=2.0)
        httpd, base = _start(app, tls_cert=str(cert))
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        try:
            body, headers = _json_body({"texts": ["the"]})
            req = urllib.request.Request(base.replace("http:", "https:") + "/v1/embed/text",
                                         data=body, headers=headers)
            with urllib.request.urlopen(req, timeout=30, context=ctx) as resp:
                assert resp.status == 200
                assert np.isfinite(np.asarray(json.loads(resp.read())["embeddings"])).all()
        finally:
            _stop(httpd, app)


class TestReusePort:
    def test_reuse_port_requires_explicit_port(self, engines):
        app = tserve.ServeApp(engines[1], max_wait_ms=1.0)
        try:
            with pytest.raises(ValueError, match="explicit port"):
                tserve.make_server(app, port=0, reuse_port=True)
        finally:
            app.close()

    def test_two_servers_one_port(self, engines):
        if not hasattr(socket, "SO_REUSEPORT"):
            pytest.skip("platform lacks SO_REUSEPORT")
        apps = [tserve.ServeApp(engines[1], max_wait_ms=1.0) for _ in range(2)]
        probe = socket.socket()
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
        try:
            servers = [tserve.make_server(a, port=port, reuse_port=True) for a in apps]
        finally:
            probe.close()
        try:
            for s in servers:
                threading.Thread(target=s.serve_forever, daemon=True).start()
            for _ in range(4):
                assert _request(f"http://127.0.0.1:{port}/healthz")[0] == 200
        finally:
            for s, a in zip(servers, apps):
                _stop(s, a)

    def test_plain_bind_still_exclusive(self, engines):
        app = tserve.ServeApp(engines[1], max_wait_ms=1.0)
        try:
            s1 = tserve.make_server(app, port=0)
            with pytest.raises(OSError):
                tserve.make_server(app, port=s1.server_address[1])
            s1.server_close()
        finally:
            app.close()


# ---------------------------------------------------------------------------
# On the card: the engine's rows and its launches (skipped without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine's kernels are compiled with "
                    "nvcc for sm_90a and have no CPU mode")
    return torch.device("cuda")


def _card_model():
    """A DebiasCLIP whose widths the CUDA GEMMs take (D % 128, head dim 64)."""
    from debias_vision_lang_torch.core.config import CLIPConfig as TC
    from debias_vision_lang_torch.core.config import DebiasConfig as TDC
    from debias_vision_lang_torch.core.config import TextConfig as TT
    from debias_vision_lang_torch.core.config import VisionConfig as TV
    from debias_vision_lang_torch.models.clip import init_clip_params as tinit

    cfg = TC(name="card-serve",
             vision=TV(kind="vit", image_size=64, patch_size=16, width=128, layers=2,
                       heads=2, embed_dim=64),
             text=TT(vocab_size=49408, context_length=77, width=128, layers=2, heads=2,
                     embed_dim=64))
    clip = CLIP(cfg)
    clip.load_state_dict(tinit(cfg, torch.Generator().manual_seed(0)))
    tokens = torch.randn(2, 128, generator=torch.Generator().manual_seed(1)) * 0.02
    return TDebiasCLIP(clip, tokens, TDC(hidden_dim=128))


def _within_one_bf16_ulp(got, want):
    mag = np.abs(want).max(-1, keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_cuda_engine_rows_equal_direct_at_every_bucket(cuda, dtype):
    from debias_vision_lang_torch.ops import fused_block as fb
    from debias_vision_lang_torch.ops import fused_block_q as fbq
    from debias_vision_lang_torch.text import ByteTokenizer

    e = tserve.InferenceEngine(_card_model(), ByteTokenizer(), max_batch=16,
                               compute_dtype=dtype, device=cuda)
    e.warmup()
    rng = np.random.default_rng(0)
    img_kernel = "attention_block_q" if dtype == "int8" else "attention_block"
    b = 1
    while b <= e.max_batch:
        n = b if b <= 2 else b - 1  # a ragged bucket from 4 up
        frames = rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)
        fb.reset_launches()
        fbq.reset_launches()
        out = e.embed_image_arrays(list(frames))
        torch.cuda.synchronize()
        launches = {**fb.LAUNCHES, **fbq.LAUNCHES}
        assert launches[img_kernel] == 2 and sum(launches.values()) == 4, launches
        staged = np.zeros((b, 16, 16 * 16 * 3), np.uint8)
        staged[:n] = patchify_u8(frames, 16)
        with torch.inference_mode():
            direct = e.model.encode_image(torch.from_numpy(staged).to(cuda),
                                          dtype=torch.bfloat16).float().cpu().numpy()
        _within_one_bf16_ulp(out, direct[:n])
        toks = list(e.tokenize([f"prompt {i}" for i in range(n)]))
        fb.reset_launches()
        txt = e.embed_token_arrays(toks)
        torch.cuda.synchronize()
        assert fb.LAUNCHES["attention_block_causal"] == 2 and fb.LAUNCHES["mlp_block"] == 2
        padded = np.zeros((b, 77), np.int64)
        padded[:n] = np.stack(toks)
        with torch.inference_mode():
            direct_t = e.model.encode_text(torch.from_numpy(padded).to(cuda),
                                           dtype=torch.bfloat16).float().cpu().numpy()
        _within_one_bf16_ulp(txt, direct_t[:n])
        b <<= 1
