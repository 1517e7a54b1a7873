"""OpenAI-compatible HTTP server over :class:`NativeEngine` (port of the
completion surface of ``fusioninfer_tpu/engine/server.py``).

Endpoints: ``POST /v1/completions`` (blocking JSON, or SSE with
``"stream": true``), ``GET /v1/models`` and ``GET /health``.  One
engine-loop thread steps the engine and routes each :class:`StepOutput`
to the channel of its request; handler threads (stdlib
``ThreadingHTTPServer``) block on their channel.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from fusioninfer_tpu_torch.engine.engine import NativeEngine, Request, StepOutput
from fusioninfer_tpu_torch.engine.sampler import SamplingParams
from fusioninfer_tpu_torch.engine.tokenizer import ByteTokenizer

logger = logging.getLogger("fusioninfer.torch.server")

# a handler waiting this long on an engine that emits nothing for its
# request gives up instead of holding the connection forever
_STREAM_IDLE_TIMEOUT_S = 300.0

# request fields of the OpenAI surface this slice does not serve yet;
# a request naming one gets a 400 rather than a silently different answer
_UNSUPPORTED = ("logprobs", "logit_bias", "response_format", "echo", "tools",
                "suffix", "best_of")


class _RequestChannel:
    """Blocking bridge from the engine thread to a handler thread."""

    def __init__(self):
        self.q: queue.Queue = queue.Queue()

    def put(self, item) -> None:
        self.q.put(item)

    def stream(self):
        while True:
            try:
                item = self.q.get(timeout=_STREAM_IDLE_TIMEOUT_S)
            except queue.Empty:
                raise TimeoutError(
                    f"engine produced no output for {_STREAM_IDLE_TIMEOUT_S:.0f}s")
            yield item
            if item is None or item.finished:
                return


def _find_stop(text: str, stops) -> int | None:
    """Earliest index where any stop sequence begins, or None."""
    best = None
    for stop in stops:
        i = text.find(stop)
        if i != -1 and (best is None or i < best):
            best = i
    return best


def _held_back(text: str, stops) -> int:
    """Length of the longest text suffix that could still grow into a stop
    sequence: streamed deltas hold it back."""
    held = 0
    for stop in stops:
        for k in range(min(len(stop) - 1, len(text)), 0, -1):
            if text.endswith(stop[:k]):
                held = max(held, k)
                break
    return held


class EngineServer:
    def __init__(self, engine: NativeEngine, host: str = "127.0.0.1",
                 port: int = 8000):
        self.engine = engine
        self.model_name = engine.cfg.name
        self.host = host
        self.port = port
        self.tokenizer = ByteTokenizer()
        self._lock = threading.Lock()
        self._channels: dict[str, _RequestChannel] = {}
        self._stop = threading.Event()
        self._engine_thread: threading.Thread | None = None
        self._http_thread: threading.Thread | None = None
        self._httpd: ThreadingHTTPServer | None = None

    # -- engine loop ---------------------------------------------------------

    def _engine_loop(self) -> None:
        while not self._stop.is_set():
            if not self.engine.has_work():
                self._stop.wait(0.002)
                continue
            try:
                outputs = self.engine.step()
            except Exception as e:  # noqa: BLE001 - the loop must survive and report
                logger.exception("engine step failed")
                outputs = self._fail_all(f"error:engine step failed: {e}")
            for out in outputs:
                with self._lock:
                    chan = self._channels.get(out.request_id)
                if chan is not None:
                    chan.put(out)

    def _fail_all(self, reason: str) -> list[StepOutput]:
        """A raising step leaves the batch in an unknown state: fail every
        registered request to its client and cancel it in the engine (the
        next step drops it)."""
        with self._lock:
            rids = list(self._channels)
        for rid in rids:
            self.engine.cancel(rid)
        return [StepOutput(request_id=rid, token=0, finished=True,
                           finish_reason=reason) for rid in rids]

    # -- requests ------------------------------------------------------------

    def submit(self, prompt_tokens: list[int], params: SamplingParams) -> tuple[str, _RequestChannel]:
        request_id = uuid.uuid4().hex[:16]
        chan = _RequestChannel()
        with self._lock:
            self._channels[request_id] = chan
        try:
            self.engine.add_request(Request(request_id, prompt_tokens, params))
        except ValueError:
            with self._lock:
                self._channels.pop(request_id, None)
            raise
        return request_id, chan

    def _release(self, request_id: str, finished: bool) -> None:
        with self._lock:
            self._channels.pop(request_id, None)
        if not finished:
            self.engine.cancel(request_id)

    def _sampling_params(self, body: dict) -> SamplingParams:
        for name in _UNSUPPORTED:
            if body.get(name) not in (None, False):
                raise ValueError(f"{name!r} is not supported by this server")
        if int(body.get("n", 1)) != 1:
            raise ValueError("only n=1 is supported by this server")
        vocab = self.engine.cfg.vocab_size
        extra_stop = body.get("stop_token_ids") or []
        if not isinstance(extra_stop, list) or any(
                not isinstance(t, int) or not 0 <= t < vocab for t in extra_stop):
            raise ValueError(f"stop_token_ids must be token ids in [0, {vocab})")
        stop = body.get("stop") or ()
        if isinstance(stop, str):
            stop = (stop,)
        elif not isinstance(stop, (list, tuple)):
            raise ValueError("stop must be a string or a list of strings")
        if any(not isinstance(x, str) or not x for x in stop):
            raise ValueError("stop sequences must be non-empty strings")
        min_p = float(body.get("min_p", 0.0))
        if not 0.0 <= min_p <= 1.0:
            raise ValueError("min_p must be in [0, 1]")
        mt = body.get("max_tokens")
        if mt is None:
            mt = body.get("max_completion_tokens")
        seed = body.get("seed")
        return SamplingParams(
            temperature=float(body.get("temperature", 1.0)),
            top_k=int(body.get("top_k", 0)),
            top_p=float(body.get("top_p", 1.0)),
            min_p=min_p,
            max_tokens=int(mt) if mt is not None else 128,
            min_tokens=int(body.get("min_tokens", 0)),
            stop_token_ids=tuple([self.tokenizer.eos_token_id, *extra_stop]),
            stop_strings=tuple(stop),
            presence_penalty=float(body.get("presence_penalty", 0.0)),
            frequency_penalty=float(body.get("frequency_penalty", 0.0)),
            repetition_penalty=float(body.get("repetition_penalty", 1.0)),
            seed=int(seed) if seed is not None else None,
        )

    def _prompt(self, body: dict) -> tuple[list[int], SamplingParams]:
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            prompt = prompt[0] if prompt else ""
        if not isinstance(prompt, str):
            raise ValueError("prompt must be a string")
        return self.tokenizer.encode(prompt), self._sampling_params(body)

    def handle_completion(self, body: dict) -> dict:
        prompt_tokens, params = self._prompt(body)
        rid, chan = self.submit(prompt_tokens, params)
        tokens: list[int] = []
        finish_reason = "length"
        stop_cut = None
        finished = False
        try:
            for out in chan.stream():
                if out is None:
                    break
                if (out.finish_reason or "").startswith("error"):
                    finish_reason, finished = out.finish_reason, True
                    break
                tokens.append(out.token)
                if params.stop_strings:
                    full = self.tokenizer.decode(tokens)
                    hit = _find_stop(full, params.stop_strings)
                    if hit is not None:
                        stop_cut, finish_reason = hit, "stop"
                        break
                if out.finished:
                    finish_reason, finished = out.finish_reason or "length", True
        finally:
            self._release(rid, finished)
        if finish_reason == "stop" and tokens and tokens[-1] == self.tokenizer.eos_token_id:
            tokens = tokens[:-1]
        text = self.tokenizer.decode(tokens)
        if stop_cut is not None:
            text = text[:stop_cut]
            while tokens and len(self.tokenizer.decode(tokens[:-1])) >= stop_cut:
                tokens = tokens[:-1]
        return {
            "id": f"cmpl-{uuid.uuid4().hex[:12]}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": [{"index": 0, "text": text, "finish_reason": finish_reason,
                         "logprobs": None}],
            "usage": {"prompt_tokens": len(prompt_tokens),
                      "completion_tokens": len(tokens),
                      "total_tokens": len(prompt_tokens) + len(tokens)},
        }

    def stream_completion(self, body: dict):
        """Validate and submit eagerly (so a bad request still gets a JSON
        400), then return a generator of SSE chunk dicts ending in None."""
        prompt_tokens, params = self._prompt(body)
        rid, chan = self.submit(prompt_tokens, params)
        return self._stream_chunks(rid, chan, params.stop_strings)

    def _stream_chunks(self, rid: str, chan: _RequestChannel, stops: tuple):
        completion_id = f"cmpl-{uuid.uuid4().hex[:12]}"
        created = int(time.time())
        tokens: list[int] = []
        emitted = 0
        finished = False
        try:
            for out in chan.stream():
                if out is None:
                    return
                finished = out.finished
                is_error = (out.finish_reason or "").startswith("error")
                counted = not is_error and not (
                    out.finished and out.finish_reason == "stop"
                    and out.token == self.tokenizer.eos_token_id)
                if counted:
                    tokens.append(out.token)
                full = self.tokenizer.decode(tokens)
                finish = (out.finish_reason or "length") if out.finished else None
                if stops:
                    hit = _find_stop(full, stops)
                    if hit is not None:
                        full, finish = full[:hit], "stop"
                    elif not out.finished:
                        full = full[: len(full) - _held_back(full, stops)]
                if finish is None:
                    # hold back a split multi-byte character until it completes
                    full = full[:len(full.rstrip("�"))]
                delta, emitted = full[emitted:], max(emitted, len(full))
                choice = {"index": 0, "text": delta, "finish_reason": finish,
                          "logprobs": None}
                if counted:
                    choice["token_id"] = out.token
                yield {"id": completion_id, "object": "text_completion",
                       "created": created, "model": self.model_name,
                       "choices": [choice]}
                if finish is not None:
                    break
        finally:
            self._release(rid, finished)
        yield None

    # -- HTTP ----------------------------------------------------------------

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _send_json(self, obj: dict, code: int = 200) -> None:
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path in ("/health", "/healthz"):
                    eng = server.engine
                    self._send_json({"status": "ok", "running": eng.num_running,
                                     "waiting": eng.num_waiting,
                                     "device": str(eng.device),
                                     "sched": eng.sched.snapshot()})
                elif self.path == "/v1/models":
                    self._send_json({"object": "list", "data": [{
                        "id": server.model_name, "object": "model",
                        "owned_by": "fusioninfer",
                        "max_model_len": server.engine.cache_cfg.max_len}]})
                else:
                    self._send_json({"error": {"message": f"not found: {self.path}"}}, 404)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    self._send_json({"error": {"message": "invalid JSON body"}}, 400)
                    return
                if self.path != "/v1/completions":
                    self._send_json({"error": {"message": f"not found: {self.path}"}}, 404)
                    return
                try:
                    if body.get("stream"):
                        self._send_sse(server.stream_completion(body))
                    else:
                        self._send_json(server.handle_completion(body))
                except ValueError as e:
                    self._send_json({"error": {"message": str(e),
                                               "type": "invalid_request_error"}}, 400)
                except Exception as e:  # noqa: BLE001 - report, keep serving
                    logger.exception("request failed")
                    self._send_json({"error": {"message": str(e)}}, 500)

            def _send_sse(self, chunks) -> None:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def write_chunk(payload: bytes) -> None:
                    self.wfile.write(f"{len(payload):X}\r\n".encode() + payload + b"\r\n")
                    self.wfile.flush()

                try:
                    for chunk in chunks:
                        if chunk is None:
                            write_chunk(b"data: [DONE]\n\n")
                        else:
                            write_chunk(f"data: {json.dumps(chunk)}\n\n".encode())
                    write_chunk(b"")  # chunked EOF
                finally:
                    chunks.close()  # client gone mid-stream: release the request

            def log_message(self, *args):
                pass

        return Handler

    def start(self) -> None:
        self._engine_thread = threading.Thread(target=self._engine_loop,
                                               daemon=True, name="engine")
        self._engine_thread.start()
        self._httpd = ThreadingHTTPServer((self.host, self.port), self._make_handler())
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(target=self._httpd.serve_forever,
                                             daemon=True, name="http")
        self._http_thread.start()
        logger.info("serving %s on %s:%d", self.model_name, self.host, self.port)

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the HTTP server and the engine loop, joining both within
        ``timeout`` seconds."""
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        for t in (self._http_thread, self._engine_thread):
            if t is not None:
                t.join(timeout)


def engine_from_args(args) -> NativeEngine:
    """Build the serve engine from ``engine serve`` flags; decode's
    split-KV walk engages from the static cache config, and
    ``--kv-cache-dtype int8`` makes the pages int8."""
    from fusioninfer_tpu_torch.engine.engine import resolve_device
    from fusioninfer_tpu_torch.engine.kv_cache import auto_cache_config
    from fusioninfer_tpu_torch.models.config import get_preset

    device = resolve_device(args.device)
    cfg = get_preset(args.model)
    kv_dtype = "int8" if args.kv_cache_dtype == "int8" else "model"
    cache_cfg = auto_cache_config(cfg, args.page_size, args.max_model_len,
                                  args.max_batch_size, device, kv_dtype)
    return NativeEngine(cfg, cache_cfg, max_batch_size=args.max_batch_size,
                        seed=args.seed, device=device)


def serve_from_args(args) -> int:
    engine = engine_from_args(args)
    server = EngineServer(engine, host=args.host, port=args.port)
    server.start()
    try:
        while server._engine_thread.is_alive():
            server._engine_thread.join(1.0)
    except KeyboardInterrupt:
        logger.info("interrupted; shutting down")
    finally:
        server.stop()
    return 0
