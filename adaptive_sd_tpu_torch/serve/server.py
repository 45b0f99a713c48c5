"""HTTP serving API (aiohttp).

Role parity: reference ``src/serving/server.py`` (FastAPI app with lifespan
model loading, endpoints GET /health, POST /generate, POST /batch_generate,
GET /stats, POST /update_lambda, POST /reset_stats, GET /models,
GET /cache_stats; CORS; single worker for device sharing). aiohttp instead of
FastAPI (not in this image); pydantic still validates all payloads
(serve/schemas.py). Device work runs in the pipeline's thread pool so the
event loop stays responsive (kernel launches return before the device
finishes). Own copy of ``adaptive_sd_tpu/serve/server.py``; ``aiohttp`` and
``pydantic`` are imported only inside this package.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Optional

from aiohttp import web
from pydantic import ValidationError as PydanticValidationError

from ..cascade.pipeline import AdaptiveCascadePipeline
from ..core.types import RequestContext
from ..utils.timing import RateLimiter
from .schemas import (
    BatchGenerationRequest,
    GenerationRequest,
    GenerationResponse,
    LambdaUpdateRequest,
    StatsResponse,
)


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


def _json_error(status: int, message: str) -> web.Response:
    return web.json_response({"error": message}, status=status)


def build_app(
    pipeline: AdaptiveCascadePipeline,
    *,
    rate_limit_rps: float = 0.0,
    api_key: str = "",
    cors_origins: tuple[str, ...] = ("*",),
) -> web.Application:
    app = web.Application(client_max_size=4 << 20)
    app["pipeline"] = pipeline
    app["start_time"] = time.time()
    limiter: Optional[RateLimiter] = (
        RateLimiter(rate_limit_rps, burst=max(int(rate_limit_rps), 1))
        if rate_limit_rps > 0
        else None
    )

    @web.middleware
    async def middleware(request: web.Request, handler):
        if api_key and request.headers.get("x-api-key") != api_key:
            return _json_error(401, "invalid api key")
        if limiter is not None and not limiter.try_acquire():
            return _json_error(429, "rate limit exceeded")
        try:
            resp = await handler(request)
        except web.HTTPException:
            raise
        except json.JSONDecodeError:
            return _json_error(400, "request body must be valid JSON")
        except PydanticValidationError as exc:
            return _json_error(422, json.loads(exc.json())[0].get("msg", "validation error"))
        except Exception as exc:  # noqa: BLE001 - uniform API boundary
            return _json_error(500, f"{type(exc).__name__}: {exc}")
        origin = cors_origins[0] if cors_origins else "*"
        resp.headers["Access-Control-Allow-Origin"] = origin
        return resp

    app.middlewares.append(middleware)

    async def health(request: web.Request) -> web.Response:
        pipe: AdaptiveCascadePipeline = request.app["pipeline"]
        return web.json_response(
            {
                "status": "healthy",
                "uptime_s": time.time() - request.app["start_time"],
                "stages": [s.name for s in pipe.stages],
                "lambda": pipe.lam,
            }
        )

    async def generate(request: web.Request) -> web.Response:
        body = GenerationRequest(**await request.json())
        pipe: AdaptiveCascadePipeline = request.app["pipeline"]
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
            return web.json_response(_response_of(result).model_dump(), status=500)
        return web.json_response(_response_of(result).model_dump())

    async def batch_generate(request: web.Request) -> web.Response:
        body = BatchGenerationRequest(**await request.json())
        pipe: AdaptiveCascadePipeline = request.app["pipeline"]
        ctxs = [
            RequestContext(
                prompt=p, max_tokens=body.max_tokens, temperature=body.temperature
            )
            for p in body.prompts
        ]
        loop = asyncio.get_running_loop()
        t0 = time.perf_counter()
        results = await loop.run_in_executor(None, pipe.batch_process, ctxs)
        return web.json_response(
            {
                "results": [_response_of(r).model_dump() for r in results],
                "batch_latency_s": time.perf_counter() - t0,
            }
        )

    async def stats(request: web.Request) -> web.Response:
        pipe: AdaptiveCascadePipeline = request.app["pipeline"]
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
            uptime_s=time.time() - request.app["start_time"],
            schedulers=s.get("schedulers", []),
        )
        return web.json_response(payload.model_dump())

    async def update_lambda(request: web.Request) -> web.Response:
        body = LambdaUpdateRequest(**await request.json())
        pipe: AdaptiveCascadePipeline = request.app["pipeline"]
        pipe.update_lambda(body.lambda_value)
        return web.json_response({"lambda": pipe.lam})

    async def reset_stats(request: web.Request) -> web.Response:
        request.app["pipeline"].reset_stats()
        return web.json_response({"reset": True})

    async def models(request: web.Request) -> web.Response:
        pipe: AdaptiveCascadePipeline = request.app["pipeline"]
        return web.json_response({"models": pipe.stages.info(), "costs": pipe.costs})

    async def cache_stats(request: web.Request) -> web.Response:
        pipe = request.app["pipeline"]
        out = dict(pipe.cache.stats())
        prefix = {}
        for st in pipe.stages:
            eng = getattr(st, "engine", None)
            pc = getattr(eng, "prefix_cache", None) if eng is not None else None
            if pc is not None:
                prefix[st.name] = pc.stats()
        if prefix:
            out["prefix_kv"] = prefix
        return web.json_response(out)

    async def generate_stream(request: web.Request) -> web.StreamResponse:
        """SSE streaming endpoint: `data: <chunk>` lines, then a final
        `event: done` with routing metadata."""
        body = GenerationRequest(**await request.json())
        pipe: AdaptiveCascadePipeline = request.app["pipeline"]
        ctx = RequestContext(
            prompt=body.prompt,
            max_tokens=body.max_tokens,
            temperature=body.temperature,
            top_p=body.top_p,
            lambda_override=body.lambda_override,
        )
        resp = web.StreamResponse(
            headers={"Content-Type": "text/event-stream", "Cache-Control": "no-cache"}
        )
        await resp.prepare(request)
        loop = asyncio.get_running_loop()
        gen = pipe.stream_request(ctx)

        def pull():
            try:
                return next(gen)
            except StopIteration:
                return None

        while True:
            item = await loop.run_in_executor(None, pull)
            if item is None:
                break
            if isinstance(item, dict):
                await resp.write(
                    f"event: done\ndata: {json.dumps(item)}\n\n".encode()
                )
            else:
                await resp.write(f"data: {json.dumps(item)}\n\n".encode())
        await resp.write_eof()
        return resp

    async def metrics(request: web.Request) -> web.Response:
        from ..utils.metrics import global_metrics

        return web.Response(
            text=global_metrics().export_metrics("prometheus"),
            content_type="text/plain",
        )

    app.router.add_get("/metrics", metrics)
    app.router.add_get("/health", health)
    app.router.add_post("/generate", generate)
    app.router.add_post("/generate_stream", generate_stream)
    app.router.add_post("/batch_generate", batch_generate)
    app.router.add_get("/stats", stats)
    app.router.add_post("/update_lambda", update_lambda)
    app.router.add_post("/reset_stats", reset_stats)
    app.router.add_get("/models", models)
    app.router.add_get("/cache_stats", cache_stats)
    return app


def run_server(
    pipeline: AdaptiveCascadePipeline,
    host: str = "0.0.0.0",
    port: int = 8000,
    *,
    warmup: bool = True,
    **kwargs,
) -> None:  # pragma: no cover - blocking entry point
    if warmup:
        pipeline.warmup()
    app = build_app(pipeline, **kwargs)
    try:
        web.run_app(app, host=host, port=port, print=None)
    finally:
        pipeline.shutdown()
