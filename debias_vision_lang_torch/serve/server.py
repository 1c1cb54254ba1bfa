"""HTTP serving front-end: batched CLIP/DebiasCLIP inference.

Endpoints (JSON in/out; images as base64):

  GET  /healthz            → model/device info
  POST /v1/embed/image     {"images_b64": [...]}            → {"embeddings": [[...]]}
  POST /v1/embed/text      {"texts": [...]}                 → {"embeddings": [[...]]}
  POST /v1/score           {"image_b64": ..., "texts": [...]} → {"probs": [...]}
                           (the reference README inference flow, README.md:44-75)

Raw binary batch endpoint (no JSON/base64 on either side — the measured
HTTP bottleneck on small hosts was encoding, not the stack; PERF.md):

  POST /v1/embed/image-raw   Content-Type: application/octet-stream
    X-Image-Format: u8    body = N × n_px·n_px·3 raw uint8 HWC frames,
                          back-to-back (N inferred from Content-Length)
    X-Image-Format: jpeg  body = repeated [4-byte big-endian length][JPEG]
                          records (decoded via the native ingest runtime)
    Response: raw little-endian float32 [N, D] embeddings
    (application/octet-stream, X-Count / X-Dim headers); send
    Accept: application/json to get the JSON {"embeddings": ...} form.

Single-item requests from concurrent clients coalesce into device batches
via the MicroBatcher (power-of-two buckets — bounded compile count);
multi-item requests batch trivially.  Stdlib-only (http.server), threaded.

Hardening / deployment:
  * bearer-token auth on data endpoints (``--auth-token`` /
    $DVL_SERVE_TOKEN; /healthz stays open for LB probes)
  * direct TLS termination (``--tls-cert``/``--tls-key``, TLS1.2+) for
    the exposed-instance case; production deployments should prefer a
    fronting load balancer / reverse proxy for TLS + auth + rate limits
  * scale-out: one server process per card (the engine lock serializes
    one process's device launches by design).  On one host, N processes
    on ONE port via ``--reuse-port`` (SO_REUSEPORT; the kernel balances
    connections — each process restricted to its own card with
    CUDA_VISIBLE_DEVICES).  Across hosts: horizontal replicas behind an
    LB.  Or ``--mesh auto``: one process splitting every batch over all
    visible cards.

The port's own copy of ``debias_vision_lang_tpu/serve/server.py`` (stdlib
and numpy only); ``tests/test_torch_standalone.py`` holds every route,
status code, error string and limit to the original.

Run:  python -m debias_vision_lang_torch serve --random-weights --dtype bfloat16
"""

from __future__ import annotations

import base64
import hmac
import json
import os
import ssl
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from .batcher import MicroBatcher
from .engine import InferenceEngine


class ServeApp:
    """Engine + per-modality micro-batchers; the handler delegates here."""

    def __init__(self, engine: InferenceEngine, max_wait_ms: float = 5.0):
        self.engine = engine
        # pipelined two-stage batching: dispatch (stage+launch, async) on the
        # batcher worker, blocking fetch on the finalizer thread — batch k+1
        # overlaps batch k on the device
        self._images = MicroBatcher(engine.dispatch_image_arrays,
                                    finalize=engine.fetch,
                                    max_batch=engine.max_batch,
                                    max_wait_ms=max_wait_ms, name="img-batch")
        self._texts = MicroBatcher(engine.dispatch_token_arrays,
                                   finalize=engine.fetch,
                                   max_batch=engine.max_batch,
                                   max_wait_ms=max_wait_ms, name="txt-batch")

    def close(self):
        self._images.close()
        self._texts.close()

    # -- request-level operations (thread-per-request calls these) ----------

    def _decode_b64_images(self, images_b64: List[str]) -> List[np.ndarray]:
        # undecodable image payloads are CLIENT errors (→ 400), but PIL
        # raises UnidentifiedImageError/OSError, which the handler would
        # report as 500 — normalize at the payload boundary.  Same for
        # non-string elements (b64decode raises TypeError on them).
        _check_item_count(len(images_b64), "images")
        if not all(isinstance(b, str) for b in images_b64):
            raise ValueError("images_b64 elements must be base64 strings")
        try:
            return [self.engine.prepare_image(base64.b64decode(b))
                    for b in images_b64]
        except OSError as e:
            raise ValueError(f"undecodable image payload: {e}") from e

    def _tokenize(self, texts: List[str]) -> np.ndarray:
        # over-long text is a client error (→ 400); a missing tokenizer is a
        # server configuration fault and stays a RuntimeError (→ 500)
        _check_item_count(len(texts), "texts")
        if not all(isinstance(t, str) for t in texts):
            raise ValueError("texts elements must be strings")
        try:
            return self.engine.tokenize(texts)
        except RuntimeError as e:
            if self.engine.tokenizer is None:
                raise
            raise ValueError(str(e)) from e

    def embed_images_b64(self, images_b64: List[str]) -> np.ndarray:
        arrays = self._decode_b64_images(images_b64)
        futs: List[Future] = [self._images.submit(a) for a in arrays]
        return np.stack([f.result() for f in futs])

    def embed_texts(self, texts: List[str]) -> np.ndarray:
        tokens = self._tokenize(texts)
        futs = [self._texts.submit(row) for row in tokens]
        return np.stack([f.result() for f in futs])

    def score(self, image_b64: str, texts: List[str]) -> np.ndarray:
        # submit BOTH modalities before blocking on either — sequential
        # embed calls would serialize two micro-batch windows per request
        arrays = self._decode_b64_images([image_b64])
        tokens = self._tokenize(texts)
        img_futs = [self._images.submit(a) for a in arrays]
        txt_futs = [self._texts.submit(row) for row in tokens]
        img = np.stack([f.result() for f in img_futs])
        txt = np.stack([f.result() for f in txt_futs])
        return self.engine.score(img, txt)[0]

    def embed_images_raw_u8(self, body: bytes) -> np.ndarray:
        """Raw uint8 HWC frames at the model resolution, back-to-back.

        Zero-copy views into the request body; a single-frame request rides
        the micro-batcher (cross-client coalescing), multi-frame requests go
        straight to the engine's chunked batch path."""
        n_px = self.engine.n_px
        frame = n_px * n_px * 3
        if not body or len(body) % frame:
            raise ValueError(
                f"u8 body must be a multiple of {frame} bytes "
                f"({n_px}x{n_px}x3 frames); got {len(body)}")
        arr = np.frombuffer(body, np.uint8).reshape(-1, n_px, n_px, 3)
        _check_item_count(arr.shape[0], "frames")
        if arr.shape[0] == 1:
            return self._images.submit(arr[0]).result()[None]
        return self.engine.embed_image_arrays(list(arr))

    def embed_images_raw_jpeg(self, body: bytes) -> np.ndarray:
        """[4-byte big-endian length][JPEG bytes] records; the whole
        request's decode + bit-exact resize (+ patch staging on the bf16/
        int8 rungs) runs as ONE threaded native-ingest call
        (engine.prepare_images_batch), then batches like u8."""
        records = []
        offsets = []
        off = 0
        while off < len(body):
            _check_item_count(len(records) + 1, "JPEG records")
            if off + 4 > len(body):
                raise ValueError("truncated length header in JPEG stream")
            ln = int.from_bytes(body[off:off + 4], "big")
            offsets.append(off)
            off += 4
            if ln <= 0 or off + ln > len(body):
                raise ValueError(f"bad record length {ln} at offset {off - 4}")
            records.append(body[off:off + ln])
            off += ln
        if not records:
            raise ValueError("empty JPEG stream")
        try:
            arrays = self.engine.prepare_images_batch(records)
        except ValueError as e:
            # map the record index back to its byte offset for the client
            import re

            m = re.search(r"record (\d+)", str(e))
            if m and int(m.group(1)) < len(offsets):
                raise ValueError(
                    f"{e} (record starts at offset "
                    f"{offsets[int(m.group(1))]})") from e
            raise
        if len(arrays) == 1:
            return self._images.submit(arrays[0]).result()[None]
        return self.engine.embed_image_arrays(arrays)


# request-body ceiling: 64 images × ~1.4 MB JPEG-as-base64 with headroom.
# A Content-Length beyond this is rejected up front (413) — rfile.read of an
# attacker-controlled length would otherwise buffer it all in RAM.
MAX_BODY_BYTES = 256 * 1024 * 1024
# per-request item ceiling: the body cap alone does not bound DECODED
# memory (a 256 MB stream of ~130-byte 1x1-pixel JPEG records would
# otherwise expand to ~2M resized frames ≈ 300 GB of host arrays); 1024
# items × n_px²·3 ≈ 150 MB decoded worst case.  Per-image pixel dimensions
# are capped separately at decode (engine.MAX_DECODE_PIXELS).
MAX_ITEMS_PER_REQUEST = 1024


def _check_item_count(n: int, what: str) -> None:
    if n > MAX_ITEMS_PER_REQUEST:
        raise ValueError(
            f"{n} {what} in one request exceeds the per-request limit of "
            f"{MAX_ITEMS_PER_REQUEST}; split into multiple requests")


class _Handler(BaseHTTPRequestHandler):
    app: ServeApp  # set by make_server
    auth_token: Optional[str] = None  # set by make_server; None = open
    # keep-alive: without it every request pays a fresh TCP (and TLS)
    # handshake, dominating single-image latency; safe because every
    # response path here sets Content-Length explicitly
    protocol_version = "HTTP/1.1"

    # -- plumbing ------------------------------------------------------------

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _bearer_ok(self) -> bool:
        """Constant-time bearer comparison (no response side effects)."""
        header = self.headers.get("Authorization", "")
        supplied = header[7:] if header.startswith("Bearer ") else ""
        # compare bytes: compare_digest raises TypeError on non-ASCII str
        # operands (a hostile header must 401, not kill the connection)
        return hmac.compare_digest(
            supplied.encode("utf-8", "surrogateescape"),
            self.auth_token.encode("utf-8"))

    def _drain_body(self, cap: int = 1 << 20) -> None:
        """Discard an unread request body (bounded) before an error
        response: closing with unread data triggers a TCP RST and the
        client may never see the error JSON.  Bodies beyond ``cap`` still
        force a connection close after the response."""
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
        except ValueError:
            length = 0
        remaining = min(length, cap)
        while remaining > 0:
            chunk = self.rfile.read(min(remaining, 1 << 16))
            if not chunk:
                break
            remaining -= len(chunk)
        if length > cap:
            self.close_connection = True

    def _authorized(self) -> bool:
        """Bearer-token check on data endpoints.
        /healthz stays open for load-balancer probes."""
        if self.auth_token is None or self._bearer_ok():
            return True
        self._drain_body()
        self._json(401, {"error": "missing or invalid bearer token"})
        return False

    def _json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self) -> Optional[dict]:
        body = self._read_raw()
        if body is None:
            return None
        try:
            payload = json.loads(body or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("payload must be a JSON object")
            return payload
        except ValueError as e:  # json.JSONDecodeError subclasses ValueError
            self._json(400, {"error": f"bad request body: {e}"})
            return None

    # -- routes --------------------------------------------------------------

    def do_GET(self):
        # a GET carrying a body (unusual but legal) must be drained before
        # responding or the leftover bytes desynchronize the keep-alive
        # connection (they'd parse as the next request line)
        self._drain_body()
        if self.path == "/healthz":
            if self.auth_token is not None and not self._bearer_ok():
                # liveness only for unauthenticated probes: model name,
                # mesh topology, HBM usage and traffic stats stay behind
                # the bearer token on a protected instance
                self._json(200, {"status": "ok"})
                return
            self._json(200, {"status": "ok", **self.app.engine.info(),
                             "image_batches": self.app._images.stats,
                             "text_batches": self.app._texts.stats})
        else:
            self._json(404, {"error": f"no route {self.path}"})

    def _read_raw(self) -> Optional[bytes]:
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            # unknown body length → the stream position is unrecoverable
            # for keep-alive; respond then close
            self.close_connection = True
            self._json(400, {"error": "bad Content-Length header"})
            return None
        if length < 0 or length > MAX_BODY_BYTES:
            # never read a body this size just to discard it (and the
            # declared length may never arrive — draining would stall the
            # handler): respond, then close the keep-alive stream
            self.close_connection = True
            self._json(413, {"error": f"body of {length} bytes exceeds "
                                      f"the {MAX_BODY_BYTES}-byte limit"})
            return None
        return self.rfile.read(length)

    def _emit_embeddings(self, embs: np.ndarray):
        """Raw f32 by default for the raw endpoint; JSON on request."""
        if "application/json" in self.headers.get("Accept", ""):
            self._json(200, {"embeddings": embs.tolist()})
            return
        body = np.ascontiguousarray(embs, dtype="<f4").tobytes()
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-Count", str(embs.shape[0]))
        self.send_header("X-Dim", str(embs.shape[1]))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        if not self._authorized():
            return
        if self.path == "/v1/embed/image-raw":
            body = self._read_raw()
            if body is None:
                return
            fmt = self.headers.get("X-Image-Format", "u8").lower()
            try:
                if fmt == "u8":
                    embs = self.app.embed_images_raw_u8(body)
                elif fmt == "jpeg":
                    embs = self.app.embed_images_raw_jpeg(body)
                else:
                    raise ValueError(f"unknown X-Image-Format {fmt!r} "
                                     "(expected u8 or jpeg)")
                self._emit_embeddings(embs)
            except ValueError as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        payload = self._read_json()
        if payload is None:
            return
        try:
            if self.path == "/v1/embed/image":
                images = payload.get("images_b64")
                if not isinstance(images, list) or not images:
                    raise ValueError("images_b64 must be a non-empty list")
                embs = self.app.embed_images_b64(images)
                self._json(200, {"embeddings": embs.tolist()})
            elif self.path == "/v1/embed/text":
                texts = payload.get("texts")
                if not isinstance(texts, list) or not texts:
                    raise ValueError("texts must be a non-empty list")
                embs = self.app.embed_texts(texts)
                self._json(200, {"embeddings": embs.tolist()})
            elif self.path == "/v1/score":
                image = payload.get("image_b64")
                texts = payload.get("texts")
                if not isinstance(image, str) or not isinstance(texts, list) \
                        or not texts:
                    raise ValueError("need image_b64 (str) and texts (list)")
                probs = self.app.score(image, texts)
                self._json(200, {"probs": probs.tolist()})
            else:
                self._json(404, {"error": f"no route {self.path}"})
        except ValueError as e:
            self._json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 - report, don't kill the server
            self._json(500, {"error": f"{type(e).__name__}: {e}"})


# listen backlog: the stdlib's default of 5 lets the kernel refuse or reset
# connections from a burst of concurrent clients (the very traffic the
# micro-batcher exists to coalesce)
LISTEN_BACKLOG = 128


class _Server(ThreadingHTTPServer):
    request_queue_size = LISTEN_BACKLOG


class _ReusePortServer(_Server):
    """SO_REUSEPORT listener: N independent server PROCESSES bind the same
    port and the kernel load-balances connections across them — the
    scale-out mechanism for multi-card hosts (one process per card, e.g.
    via CUDA_VISIBLE_DEVICES; workers must be separate processes, not forks
    of a CUDA-initialized one)."""

    def server_bind(self):
        import socket as _socket

        if not hasattr(_socket, "SO_REUSEPORT"):  # non-Linux fallback
            raise OSError("SO_REUSEPORT is not supported on this platform")
        self.socket.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEPORT, 1)
        super().server_bind()


def make_server(app: ServeApp, host: str = "127.0.0.1",
                port: int = 0, auth_token: Optional[str] = None,
                tls_cert: Optional[str] = None,
                tls_key: Optional[str] = None,
                reuse_port: bool = False) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; port 0 = ephemeral.

    ``auth_token``: require ``Authorization: Bearer <token>`` on every data
    endpoint (401 otherwise; /healthz stays open for LB probes).  Defaults
    to $DVL_SERVE_TOKEN when unset; pass "" to force-open an instance in an
    environment that sets the variable.

    ``tls_cert``/``tls_key``: PEM paths — wraps the listening socket in
    TLS (stdlib ssl, TLS1.2+).  For production deployments prefer a
    fronting load balancer / reverse proxy terminating TLS and doing
    request auth; these built-ins cover the direct-exposure case.

    ``reuse_port``: bind with SO_REUSEPORT so several server PROCESSES
    share one port with kernel-level connection balancing (a fixed
    ``port`` is then required — an ephemeral port would give each worker
    a different one).  This is the sanctioned multi-worker mechanism:
    launch the CLI once per card with each process's visible devices
    restricted, all on the same port — no fronting LB needed on-host."""
    if auth_token is None:
        auth_token = os.environ.get("DVL_SERVE_TOKEN") or None
    handler = type("BoundHandler", (_Handler,),
                   {"app": app, "auth_token": auth_token or None,
                    # bound per-connection blocking (incl. the lazy TLS
                    # handshake below): a stalled client times out instead
                    # of holding a handler thread forever
                    "timeout": 60})
    if reuse_port and port == 0:
        raise ValueError("reuse_port requires an explicit port: ephemeral "
                         "port 0 would bind each worker to a different one")
    server_cls = _ReusePortServer if reuse_port else _Server
    httpd = server_cls((host, port), handler)
    if tls_cert:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        ctx.load_cert_chain(tls_cert, tls_key or tls_cert)
        # do_handshake_on_connect=False: accept() must NOT block on the
        # handshake — a client that connects and never speaks TLS would
        # stall the single accept loop (unauthenticated DoS).  The
        # handshake runs lazily on first read, inside the per-connection
        # handler thread, bounded by the handler timeout.
        httpd.socket = ctx.wrap_socket(httpd.socket, server_side=True,
                                       do_handshake_on_connect=False)
    return httpd


def serve_forever(model, tokenizer=None, host: str = "127.0.0.1",
                  port: int = 8000, max_batch: int = 64,
                  max_wait_ms: float = 5.0,
                  compute_dtype: Optional[str] = None,
                  warmup: bool = True, mesh=None,
                  auth_token: Optional[str] = None,
                  tls_cert: Optional[str] = None,
                  tls_key: Optional[str] = None,
                  reuse_port: bool = False, device="cuda"):
    """Blocking entry point used by the CLI.  The model runs on ``device``
    (the card unless ``"cpu"``; without a card the default raises);
    ``mesh="auto"`` splits batches over every card of the device's type
    (``parallel.mesh.default_mesh``)."""
    if mesh == "auto":
        from ..parallel.mesh import default_mesh

        mesh = default_mesh(device)
    engine = InferenceEngine(model, tokenizer, max_batch=max_batch,
                             compute_dtype=compute_dtype, mesh=mesh,
                             device=device)
    if warmup:
        engine.warmup(log=lambda m: print(m, flush=True))
    app = ServeApp(engine, max_wait_ms=max_wait_ms)
    # token defaulting ($DVL_SERVE_TOKEN, ""-force-open) is make_server's job
    httpd = make_server(app, host, port, auth_token=auth_token,
                        tls_cert=tls_cert, tls_key=tls_key,
                        reuse_port=reuse_port)
    scheme = "https" if tls_cert else "http"
    # the handler's resolved token is the single source of truth for the
    # banner (auth_token="" force-opens even when $DVL_SERVE_TOKEN is set)
    resolved = httpd.RequestHandlerClass.auth_token
    print(f"serving {engine.info()['model']} on "
          f"{scheme}://{host}:{httpd.server_address[1]}  "
          f"(backend={engine.info()['backend']}, "
          f"dtype={engine.info()['compute_dtype']}, "
          f"auth={'bearer' if resolved else 'open'})")
    try:
        httpd.serve_forever()
    finally:
        app.close()
        httpd.server_close()
