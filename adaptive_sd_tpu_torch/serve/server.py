"""HTTP serving API on the standard library (asyncio).

Role parity: reference ``src/serving/server.py`` (FastAPI app with lifespan
model loading, endpoints GET /health, POST /generate, POST /batch_generate,
GET /stats, POST /update_lambda, POST /reset_stats, GET /models,
GET /cache_stats; CORS; single worker for device sharing). Own copy of
``adaptive_sd_tpu/serve/server.py``, which runs on aiohttp with pydantic
payloads; the card's machine has neither, so this module speaks HTTP/1.1
itself on ``asyncio.start_server`` and validates with ``serve/schemas.py``.

It answers as the JAX package's aiohttp app does: the same ten routes (a GET
route also answers HEAD), 404 for an unknown path and 405 (with ``Allow``)
for a wrong method, the same middleware (401 for a bad ``x-api-key``, 429
from the rate limiter, 400 for a body that is not JSON, 422 with pydantic's
first message, 500 for an uncaught exception, the CORS header on a handled
response), 413 once a body reaches ``client_max_size`` (4 MiB, checked from
``Content-Length`` before the body is read) with aiohttp's text, JSON as
``application/json; charset=utf-8``, and SSE on /generate_stream as chunked
transfer, flushed after each event. The request parser takes
``Content-Length`` and chunked bodies, keep-alive (HTTP/1.0 closes unless it
asks to keep alive) and ``Expect: 100-continue`` (the interim response is
sent when the handler first reads the body). One event loop; device work
runs in the loop's default executor, so the loop stays responsive (kernel
launches return before the device finishes).
"""

from __future__ import annotations

import asyncio
import email.utils
import json
import logging
import signal
import threading
import time
from http import HTTPStatus
from typing import AsyncIterator, Awaitable, Callable, Optional
from urllib.parse import unquote, urlsplit

from ..cascade.pipeline import AdaptiveCascadePipeline
from ..core.types import RequestContext
from ..utils.timing import RateLimiter
from .schemas import (
    BatchGenerationRequest,
    GenerationRequest,
    GenerationResponse,
    LambdaUpdateRequest,
    StatsResponse,
    ValidationError,
)

logger = logging.getLogger(__name__)

CLIENT_MAX_SIZE = 4 << 20       # aiohttp's client_max_size in the JAX app
HEAD_LIMIT = 64 << 10          # request line and headers together
LINGER_S = 2.0                 # reading what a client still sends after a refused body
SERVER_NAME = "adaptive-sd-tpu-torch"


# -- messages ------------------------------------------------------------------


class HTTPError(Exception):
    """An answer given as text, outside the middleware's JSON errors (404,
    405, 413, 417, a malformed request), as aiohttp's HTTPException is."""

    def __init__(self, status: int, text: Optional[str] = None, headers=None) -> None:
        super().__init__(status)
        self.status = status
        self.text = text if text is not None else f"{status}: {HTTPStatus(status).phrase}"
        self.headers = dict(headers or {})

    def response(self) -> "Response":
        return Response(self.status, self.text.encode(), "text/plain; charset=utf-8",
                        self.headers)


class Response:
    def __init__(self, status: int, body: bytes, content_type: str, headers=None) -> None:
        self.status, self.body, self.content_type = status, body, content_type
        self.headers = dict(headers or {})


class StreamResponse:
    """A response whose body is sent chunk by chunk as ``chunks`` yields it."""

    def __init__(self, chunks: AsyncIterator[bytes], headers: dict) -> None:
        self.status, self.chunks, self.headers = 200, chunks, dict(headers)


def json_response(data, status: int = 200) -> Response:
    return Response(status, json.dumps(data).encode(), "application/json; charset=utf-8")


def _json_error(status: int, message: str) -> Response:
    return json_response({"error": message}, status=status)


class Request:
    """One parsed request; its body is read when the handler asks for it."""

    def __init__(self, method: str, path: str, version: tuple, headers: dict,
                 reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        self.method, self.path, self.version, self.headers = method, path, version, headers
        self._reader, self._writer = reader, writer
        self.continue_pending = False
        self.body_done = False
        self._body: Optional[bytes] = None
        te = headers.get("transfer-encoding", "").lower()
        self.chunked = te == "chunked"
        if te and not self.chunked:
            raise HTTPError(400, f"unsupported Transfer-Encoding: {te}")
        cl = headers.get("content-length")
        if cl is not None and (self.chunked or not cl.isdigit()):
            raise HTTPError(400, "bad Content-Length")
        self.content_length = int(cl) if cl is not None else 0
        if not self.chunked and self.content_length == 0:
            self.body_done = True
        conn = {t.strip().lower() for t in headers.get("connection", "").split(",")}
        self.keep_alive = ("keep-alive" in conn) if version < (1, 1) else ("close" not in conn)

    async def read(self) -> bytes:
        if self._body is not None:
            return self._body
        if not self.chunked and self.content_length >= CLIENT_MAX_SIZE:
            # aiohttp refuses a body once it reaches client_max_size
            raise HTTPError(413, f"Maximum request body size {CLIENT_MAX_SIZE} exceeded, "
                                 f"actual body size {self.content_length}")
        if self.continue_pending:
            self.continue_pending = False
            self._writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await self._writer.drain()
        if not self.chunked:
            body = await self._reader.readexactly(self.content_length)
        else:
            parts, size = [], 0
            while True:
                line = await self._reader.readuntil(b"\r\n")
                try:
                    n = int(line.split(b";")[0].strip(), 16)
                except ValueError:
                    raise HTTPError(400, "bad chunk size") from None
                if n == 0:
                    while (await self._reader.readuntil(b"\r\n")) != b"\r\n":
                        pass       # trailers
                    break
                parts.append(await self._reader.readexactly(n))
                size += n
                if await self._reader.readexactly(2) != b"\r\n":
                    raise HTTPError(400, "bad chunk end")
                if size >= CLIENT_MAX_SIZE:
                    raise HTTPError(413, f"Maximum request body size {CLIENT_MAX_SIZE} "
                                         f"exceeded, actual body size {size}")
            body = b"".join(parts)
        self.body_done = True
        self._body = body
        return body

    async def text(self) -> str:
        charset = "utf-8"
        for param in self.headers.get("content-type", "").split(";")[1:]:
            key, _, value = param.strip().partition("=")
            if key.lower() == "charset" and value:
                charset = value.strip('"')
        return (await self.read()).decode(charset)

    async def json(self):
        return json.loads(await self.text())


async def _read_request(reader, writer) -> Optional[Request]:
    """The next request on the connection, or None when the client closed it."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if e.partial.strip():
            raise HTTPError(400, "incomplete request head") from None
        return None
    except asyncio.LimitOverrunError:
        raise HTTPError(400, f"request head larger than {HEAD_LIMIT} bytes") from None
    lines = head[:-4].decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[0].isalpha() or not parts[0].isupper():
        raise HTTPError(400, f"bad request line: {lines[0][:100]!r}")
    method, target, proto = parts
    if proto not in ("HTTP/1.0", "HTTP/1.1"):
        raise HTTPError(400, f"unsupported protocol {proto[:20]!r}")
    headers: dict = {}
    for line in lines[1:]:
        name, sep, value = line.partition(":")
        if not sep or not name or name != name.strip():
            raise HTTPError(400, f"bad header line: {line[:100]!r}")
        key = name.lower()
        value = value.strip()
        if key in headers and key == "content-length" and headers[key] != value:
            raise HTTPError(400, "conflicting Content-Length headers")
        headers[key] = f"{headers[key]}, {value}" if key in headers and key != (
            "content-length") else value
    version = (1, int(proto[-1]))
    return Request(method, unquote(urlsplit(target).path), version, headers, reader, writer)


# -- the application -----------------------------------------------------------

Handler = Callable[[Request], Awaitable]


class App:
    """Routes and middleware over one pipeline; :meth:`start` serves them."""

    def __init__(self, pipeline, *, rate_limit_rps: float = 0.0, api_key: str = "",
                 cors_origins: tuple = ("*",)) -> None:
        self.pipeline = pipeline
        self.start_time = time.time()
        self.api_key = api_key
        self.cors_origin = cors_origins[0] if cors_origins else "*"
        self.limiter: Optional[RateLimiter] = (
            RateLimiter(rate_limit_rps, burst=max(int(rate_limit_rps), 1))
            if rate_limit_rps > 0 else None)
        self.routes: dict[str, dict[str, Handler]] = {}
        self._server: Optional[asyncio.base_events.Server] = None
        self._connections: set = set()

    def add_get(self, path: str, handler: Handler) -> None:
        self.routes.setdefault(path, {}).update(GET=handler, HEAD=handler)

    def add_post(self, path: str, handler: Handler) -> None:
        self.routes.setdefault(path, {})["POST"] = handler

    # -- dispatch -----------------------------------------------------------------

    async def handle(self, request: Request):
        """Route, then the middleware, as aiohttp orders them: an unknown path
        or method is answered by the handler slot (so a bad key still gets 401)."""
        methods = self.routes.get(request.path)
        if methods is None:
            handler = _raiser(HTTPError(404))
        elif request.method not in methods:
            handler = _raiser(HTTPError(405, headers={"Allow": ",".join(sorted(methods))}))
        else:
            handler = methods[request.method]
        expect = request.headers.get("expect")
        if expect and request.version == (1, 1):
            if expect.lower() != "100-continue":
                return HTTPError(417, f"Unknown Expect: {expect}").response()
            request.continue_pending = True
        try:
            return await self._middleware(request, handler)
        except HTTPError as e:
            return e.response()

    async def _middleware(self, request: Request, handler: Handler):
        if self.api_key and request.headers.get("x-api-key") != self.api_key:
            return _json_error(401, "invalid api key")
        if self.limiter is not None and not self.limiter.try_acquire():
            return _json_error(429, "rate limit exceeded")
        try:
            resp = await handler(request)
        except HTTPError:
            raise
        except json.JSONDecodeError:
            return _json_error(400, "request body must be valid JSON")
        except ValidationError as exc:
            return _json_error(422, exc.errors()[0].get("msg", "validation error"))
        except Exception as exc:  # noqa: BLE001 - uniform API boundary
            logger.exception("request to %s failed", request.path)
            return _json_error(500, f"{type(exc).__name__}: {exc}")
        if isinstance(resp, Response):   # a stream's headers are out before this point
            resp.headers["Access-Control-Allow-Origin"] = self.cors_origin
        return resp

    # -- connections --------------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Listen on ``host:port`` (0: a free port) and return the port."""
        self._server = await asyncio.start_server(self._connection, host, port, limit=HEAD_LIMIT)
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for task in list(self._connections):
            task.cancel()
        await asyncio.gather(*self._connections, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    async def serve_until_signal(self, host: str, port: int) -> None:
        """Serve until SIGINT or SIGTERM."""
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        try:
            bound = await self.start(host, port)
            logger.info("serving on http://%s:%d", host, bound)
            await stop.wait()
            logger.info("signal received; stopping the server")
        finally:
            for sig in (signal.SIGINT, signal.SIGTERM):
                loop.remove_signal_handler(sig)
            await self.stop()

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._connections.add(task)
        linger = False
        try:
            while True:
                try:
                    request = await _read_request(reader, writer)
                except HTTPError as e:
                    await _write(writer, (1, 1), "GET", e.response(), keep=False)
                    linger = True
                    return
                if request is None:
                    return
                try:
                    resp = await self.handle(request)
                except (asyncio.IncompleteReadError, ConnectionError):
                    return
                keep = request.keep_alive and request.body_done
                if not await _write(writer, request.version, request.method, resp, keep):
                    return
                if not keep:
                    linger = not request.body_done
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._connections.discard(task)
            await _close(reader, writer, linger)


def _raiser(exc: HTTPError) -> Handler:
    async def handler(request: Request):
        raise exc

    return handler


async def _write(writer, version: tuple, method: str, resp, keep: bool) -> bool:
    """Send one response; False when the stream could not be sent whole."""
    proto = f"HTTP/{version[0]}.{version[1]}"
    headers = []
    streaming = isinstance(resp, StreamResponse)
    if streaming:
        headers += list(resp.headers.items())
        chunked = version >= (1, 1)
        if chunked:
            headers.append(("Transfer-Encoding", "chunked"))
        else:
            keep = False   # an HTTP/1.0 stream ends when the connection does
    else:
        headers.append(("Content-Type", resp.content_type))
        headers += list(resp.headers.items())
        headers.append(("Content-Length", str(len(resp.body))))
    headers += [("Date", email.utils.formatdate(usegmt=True)), ("Server", SERVER_NAME)]
    if not keep:
        headers.append(("Connection", "close"))
    elif version < (1, 1):
        headers.append(("Connection", "keep-alive"))
    head = f"{proto} {resp.status} {HTTPStatus(resp.status).phrase}\r\n" + "".join(
        f"{k}: {v}\r\n" for k, v in headers) + "\r\n"
    writer.write(head.encode("latin-1"))
    if not streaming:
        if method != "HEAD":
            writer.write(resp.body)
        await writer.drain()
        return True
    try:
        await writer.drain()
        async for chunk in resp.chunks:
            writer.write(b"%x\r\n%s\r\n" % (len(chunk), chunk) if chunked else chunk)
            await writer.drain()          # one flush an event
    except (ConnectionError, asyncio.CancelledError):
        raise
    except Exception:  # noqa: BLE001 - the headers are out: end the connection
        logger.exception("stream failed after its headers were sent")
        return False
    finally:
        await resp.chunks.aclose()
    if chunked:
        writer.write(b"0\r\n\r\n")
        await writer.drain()
    return keep


async def _close(reader, writer, linger: bool) -> None:
    """Close the connection; after a refused or unread body, first read what
    the client still sends (briefly), so that it reads the answer instead of
    a reset."""
    try:
        if linger and writer.can_write_eof():
            writer.write_eof()
            async with asyncio.timeout(LINGER_S):
                while await reader.read(1 << 16):
                    pass
    except (TimeoutError, ConnectionError, OSError):
        pass
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass


# -- the routes ------------------------------------------------------------------


def _response_of(result) -> GenerationResponse:
    return GenerationResponse(
        request_id=result.request_id,
        text=result.text,
        final_stage=result.final_stage,
        final_stage_name=result.final_stage_name,
        latency_s=result.total_latency_s,
        cost=result.total_cost,
        acceptance_probs=list(result.decision.acceptance_probs) if result.decision else [],
        cached=result.cached,
        error=result.error,
    )


def build_app(
    pipeline: AdaptiveCascadePipeline,
    *,
    rate_limit_rps: float = 0.0,
    api_key: str = "",
    cors_origins: tuple[str, ...] = ("*",),
) -> App:
    app = App(pipeline, rate_limit_rps=rate_limit_rps, api_key=api_key,
              cors_origins=cors_origins)
    pipe = pipeline

    async def health(request: Request) -> Response:
        return json_response(
            {
                "status": "healthy",
                "uptime_s": time.time() - app.start_time,
                "stages": [s.name for s in pipe.stages],
                "lambda": pipe.lam,
            }
        )

    async def generate(request: Request) -> Response:
        body = GenerationRequest(**await request.json())
        ctx = RequestContext(
            prompt=body.prompt,
            max_tokens=body.max_tokens,
            temperature=body.temperature,
            top_p=body.top_p,
            lambda_override=body.lambda_override,
            **({"request_id": body.request_id} if body.request_id else {}),
        )
        loop = asyncio.get_running_loop()
        result = await loop.run_in_executor(None, pipe.process_request, ctx)
        if result.error:
            return json_response(_response_of(result).to_dict(), status=500)
        return json_response(_response_of(result).to_dict())

    async def batch_generate(request: Request) -> Response:
        body = BatchGenerationRequest(**await request.json())
        ctxs = [
            RequestContext(prompt=p, max_tokens=body.max_tokens, temperature=body.temperature)
            for p in body.prompts
        ]
        loop = asyncio.get_running_loop()
        t0 = time.perf_counter()
        results = await loop.run_in_executor(None, pipe.batch_process, ctxs)
        return json_response(
            {
                "results": [_response_of(r).to_dict() for r in results],
                "batch_latency_s": time.perf_counter() - t0,
            }
        )

    async def stats(request: Request) -> Response:
        s = pipe.get_stats()
        payload = StatsResponse(
            total_requests=s["total_requests"],
            error_rate=s["error_rate"],
            ema_latency_s=s["ema_latency_s"],
            ema_cost=s["ema_cost"],
            stage_distribution=s["stage_distribution"],
            early_stop_rate=s["early_stop_rate"],
            lambda_value=s["lambda"],
            acceptance_priors=s["acceptance_priors"],
            cache=s["cache"],
            uptime_s=time.time() - app.start_time,
            schedulers=s.get("schedulers", []),
        )
        return json_response(payload.to_dict())

    async def update_lambda(request: Request) -> Response:
        body = LambdaUpdateRequest(**await request.json())
        pipe.update_lambda(body.lambda_value)
        return json_response({"lambda": pipe.lam})

    async def reset_stats(request: Request) -> Response:
        pipe.reset_stats()
        return json_response({"reset": True})

    async def models(request: Request) -> Response:
        return json_response({"models": pipe.stages.info(), "costs": pipe.costs})

    async def cache_stats(request: Request) -> Response:
        out = dict(pipe.cache.stats())
        prefix = {}
        for st in pipe.stages:
            eng = getattr(st, "engine", None)
            pc = getattr(eng, "prefix_cache", None) if eng is not None else None
            if pc is not None:
                prefix[st.name] = pc.stats()
        if prefix:
            out["prefix_kv"] = prefix
        return json_response(out)

    async def generate_stream(request: Request) -> StreamResponse:
        """SSE streaming endpoint: `data: <chunk>` lines, then a final
        `event: done` with routing metadata."""
        body = GenerationRequest(**await request.json())
        ctx = RequestContext(
            prompt=body.prompt,
            max_tokens=body.max_tokens,
            temperature=body.temperature,
            top_p=body.top_p,
            lambda_override=body.lambda_override,
        )
        loop = asyncio.get_running_loop()
        gen = pipe.stream_request(ctx)

        def pull():
            try:
                return next(gen)
            except StopIteration:
                return None

        async def events():
            try:
                while True:
                    item = await loop.run_in_executor(None, pull)
                    if item is None:
                        break
                    if isinstance(item, dict):
                        yield f"event: done\ndata: {json.dumps(item)}\n\n".encode()
                    else:
                        yield f"data: {json.dumps(item)}\n\n".encode()
            finally:
                await loop.run_in_executor(None, gen.close)

        return StreamResponse(
            events(), {"Content-Type": "text/event-stream", "Cache-Control": "no-cache"})

    async def metrics(request: Request) -> Response:
        from ..utils.metrics import global_metrics

        return Response(200, global_metrics().export_metrics("prometheus").encode(),
                        "text/plain; charset=utf-8")

    app.add_get("/metrics", metrics)
    app.add_get("/health", health)
    app.add_post("/generate", generate)
    app.add_post("/generate_stream", generate_stream)
    app.add_post("/batch_generate", batch_generate)
    app.add_get("/stats", stats)
    app.add_post("/update_lambda", update_lambda)
    app.add_post("/reset_stats", reset_stats)
    app.add_get("/models", models)
    app.add_get("/cache_stats", cache_stats)
    return app


class BackgroundServer:
    """``app`` served on ``host:port`` (0: a free port) by an event loop in a
    thread of its own, for tests and in-process callers; ``close()`` (or the
    end of a ``with`` block) stops it and waits for work in flight."""

    def __init__(self, app: App, host: str = "127.0.0.1", port: int = 0) -> None:
        self.app, self.host = app, host
        self._ready = threading.Event()
        self._error: Optional[BaseException] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop: Optional[asyncio.Event] = None
        self.port = port
        self._thread = threading.Thread(target=self._run, name="http-server", daemon=True)
        self._thread.start()
        if not self._ready.wait(60):
            raise TimeoutError("the HTTP server did not start")
        if self._error is not None:
            raise self._error

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _run(self) -> None:
        asyncio.run(self._main())

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        try:
            self.port = await self.app.start(self.host, self.port)
        except OSError as exc:
            self._error = exc
            self._ready.set()
            return
        self._ready.set()
        try:
            await self._stop.wait()
        finally:
            await self.app.stop()

    def close(self) -> None:
        if self._loop is not None and self._thread.is_alive():
            self._loop.call_soon_threadsafe(self._stop.set)
        self._thread.join(120)
        if self._thread.is_alive():
            raise TimeoutError("the HTTP server did not stop")

    def __enter__(self) -> "BackgroundServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run_server(
    pipeline: AdaptiveCascadePipeline,
    host: str = "0.0.0.0",
    port: int = 8000,
    *,
    warmup: bool = True,
    **kwargs,
) -> None:  # pragma: no cover - blocking entry point
    """Warm the pipeline up, serve until SIGINT or SIGTERM, then shut the
    pipeline down."""
    if warmup:
        pipeline.warmup()
    app = build_app(pipeline, **kwargs)
    try:
        asyncio.run(app.serve_until_signal(host, port))
    finally:
        pipeline.shutdown()
