#!/usr/bin/env python3
"""Which collectives a gloo process group takes for CUDA tensors, on ranks
that share one card, and what each costs.

    python3 scripts/torch_gloo_cuda_probe.py [--world 2] [--reps 50] [--host-mib 2048]

Starts ``--world`` ranks on ``cuda:0`` through
``adaptive_sd_tpu_torch.parallel.spawn_ranks`` (gloo, ``file://``
rendezvous) and tries, on CUDA tensors: ``all_reduce`` (f32, bf16),
``all_gather``, ``all_gather_into_tensor``, ``broadcast``, then, in a
world of its own (a crash there must not lose the rest), the ring hop of
parallel/overlap.py as ``batch_isend_irecv``. Each result is checked
against the sum or copy computed on the host. For the collectives that
work it prints the mean milliseconds of one call at the tensor-parallel
forward's payloads (a decode row and a 512-token window of Qwen2.5-7B's
hidden size, and for ``all_gather`` its vocabulary's half, f32), beside the
same call with the CUDA tensor staged through host memory by the caller
(``.to("cpu")``, the collective on the CPU tensor, one copy back), on a
CPU tensor alone, and through parallel/host_memory.py (shared host memory,
what ``TPGroup`` uses for these ranks). Then it times, on every rank at
once, ``--host-mib`` MiB from the card to host memory in four ways
(``_host_copy``), with and without torch's huge-page option for CPU
allocations (``THP_MEM_ALLOC_ENABLE``). One JSON line per result; the
last line names the card and its power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from adaptive_sd_tpu_torch.core.device import describe_device  # noqa: E402
from adaptive_sd_tpu_torch.parallel import spawn_ranks  # noqa: E402
from adaptive_sd_tpu_torch.parallel.host_memory import HostMemoryCollectives  # noqa: E402

HIDDEN = 3584  # Qwen2.5-7B
VOCAB = 152064


def _check(rank, world, name, fn):
    try:
        ok = bool(fn())
        return {"op": name, "ok": ok}
    except Exception as exc:  # noqa: BLE001 - the probe reports what each op raises
        return {"op": name, "ok": False, "error": f"{type(exc).__name__}: {exc}"[:300]}


def _collectives(rank: int, device, reps: int) -> list:
    world = dist.get_world_size()
    out = []

    def all_reduce(dtype):
        x = torch.full((1000,), float(rank + 1), dtype=dtype, device=device)
        dist.all_reduce(x)
        return torch.equal(x.cpu(), torch.full((1000,), float(world * (world + 1) // 2),
                                               dtype=dtype))

    def all_gather():
        x = torch.full((7,), float(rank), device=device)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return all(bool((p.cpu() == r).all()) for r, p in enumerate(parts))

    def all_gather_into_tensor():
        x = torch.full((7,), float(rank), device=device)
        y = torch.empty(world * 7, device=device)
        dist.all_gather_into_tensor(y, x)
        return torch.equal(y.cpu(), torch.arange(world).repeat_interleave(7).float())

    def broadcast():
        x = torch.full((5,), float(rank + 3), device=device)
        dist.broadcast(x, src=0)
        return bool((x.cpu() == 3.0).all())

    out.append(_check(rank, world, "all_reduce_f32", lambda: all_reduce(torch.float32)))
    out.append(_check(rank, world, "all_reduce_bf16", lambda: all_reduce(torch.bfloat16)))
    out.append(_check(rank, world, "all_gather", all_gather))
    out.append(_check(rank, world, "all_gather_into_tensor", all_gather_into_tensor))
    out.append(_check(rank, world, "broadcast", broadcast))
    def staged(x):
        h = x.to("cpu")
        dist.all_reduce(h)
        x.copy_(h)

    def gather_staged(x):
        parts = [torch.empty_like(x, device="cpu") for _ in range(world)]
        dist.all_gather(parts, x.to("cpu"))
        torch.cat(parts, dim=-1).to(device)

    def gather_cuda(x):
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        torch.cat(parts, dim=-1)

    x = torch.randn(4, HIDDEN, device=device)
    y = x.clone()
    dist.all_reduce(x)
    staged(y)
    out.append({"op": "all_reduce_staged_equal_cuda", "ok": torch.equal(x, y)})
    hm = HostMemoryCollectives(dist.group.WORLD, list(range(world)), rank)
    x = torch.randn(4, HIDDEN, device=device)
    y = x.clone()
    dist.all_reduce(x)
    hm.all_reduce(y)
    out.append({"op": "all_reduce_host_memory_equal_cuda", "ok": torch.equal(x, y)})
    cases = [("all_reduce_f32_time", dist.all_reduce, HIDDEN, "cuda"),
             ("all_reduce_f32_host_memory_time", hm.all_reduce, HIDDEN, "cuda"),
             ("all_gather_f32_host_memory_time", hm.all_gather_last, VOCAB // world, "cuda"),
             ("all_reduce_f32_staged_time", staged, HIDDEN, "cuda"),
             ("all_reduce_f32_cpu_tensor_time", dist.all_reduce, HIDDEN, "cpu"),
             ("all_gather_f32_time", gather_cuda, VOCAB // world, "cuda"),
             ("all_gather_f32_staged_time", gather_staged, VOCAB // world, "cuda")]
    for name, op, width, where in cases:
        for rows in (1, 512):
            x = torch.randn(rows, width, device=device if where == "cuda" else "cpu")
            if "host_memory" in name and not hm.fits(x):
                continue
            n = reps if rows == 1 else max(reps // 10, 3)
            for _ in range(3):
                op(x)
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(n):
                op(x)
            torch.cuda.synchronize()
            out.append({"op": name, "rows": rows, "width": width,
                        "ms": (time.perf_counter() - t0) / n * 1e3})
    return out


def _host_copy(rank: int, device, mib: int) -> list:
    """Seconds to copy ``mib`` MiB from the card to host memory, on every
    rank at once (as the tp phase's ranks copy their host trees): to
    pageable memory; to pinned memory, the pinning counted; through one
    pinned 256 MiB staging buffer into pageable memory; and to touch as
    much fresh pageable memory, alone. Then the seconds to release the
    pinned cache (unpinning), where torch has the call."""
    x = torch.empty(mib << 20, dtype=torch.uint8, device=device)
    out = []
    for kind in ("pageable", "pinned", "staged", "touch"):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        if kind == "pinned":
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x)
        elif kind == "staged":
            stage = torch.empty(256 << 20, dtype=torch.uint8, pin_memory=True)
            h = torch.empty(x.shape, dtype=x.dtype)
            for i in range(0, x.numel(), stage.numel()):
                n = min(stage.numel(), x.numel() - i)
                h[i:i + n].copy_(stage[:n].copy_(x[i:i + n]))
        elif kind == "touch":
            h = torch.empty(x.shape, dtype=x.dtype).fill_(1)
        else:
            h = x.to("cpu")
        secs = time.perf_counter() - t0
        out.append({"op": f"d2h_{kind}", "mib": mib, "s": secs, "gb_s": (mib << 20) / secs / 1e9,
                    "thp_alloc": os.environ.get("THP_MEM_ALLOC_ENABLE", "")})
        del h
    release = getattr(torch._C, "_accelerator_emptyHostCache", None)
    if release is not None:
        t0 = time.perf_counter()
        release()
        out.append({"op": "unpin_cached", "s": time.perf_counter() - t0})
    return out


def _ring(rank: int, device) -> list:
    world = dist.get_world_size()

    def hop():
        x = torch.full((9,), float(rank), device=device)
        buf = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, (rank + 1) % world),
                                       dist.P2POp(dist.irecv, buf, (rank - 1) % world)])
        for r in reqs:
            r.wait()
        return bool((buf.cpu() == float((rank - 1) % world)).all())

    return [_check(rank, world, "batch_isend_irecv_cuda", hop)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--host-mib", type=int, default=2048)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    devices = ["cuda:0"] * args.world
    card = describe_device("cuda")
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "world": args.world, "backend": "gloo", "devices": devices}), flush=True)
    t0 = time.perf_counter()
    per_rank = spawn_ranks(_collectives, args.world, args.reps, devices=devices, timeout_s=60)
    print(json.dumps({"spawn_and_run_s": time.perf_counter() - t0}), flush=True)
    for rank, rows in enumerate(per_rank):
        for row in rows:
            print(json.dumps({"rank": rank, **row}), flush=True)
    for thp in ("", "1"):  # torch's huge-page option for its CPU allocations, in the ranks
        os.environ["THP_MEM_ALLOC_ENABLE"] = thp
        for rank, rows in enumerate(spawn_ranks(_host_copy, args.world, args.host_mib,
                                                devices=devices, timeout_s=120)):
            for row in rows:
                print(json.dumps({"rank": rank, **row}), flush=True)
    os.environ.pop("THP_MEM_ALLOC_ENABLE")
    try:
        rows = spawn_ranks(_ring, args.world, devices=devices, timeout_s=30)
        for rank, rr in enumerate(rows):
            for row in rr:
                print(json.dumps({"rank": rank, **row}), flush=True)
    except Exception as exc:  # noqa: BLE001 - a rank that raises is the answer
        # the rank's traceback ends in the error it raised
        print(json.dumps({"op": "batch_isend_irecv_cuda", "ok": False,
                          "error": str(exc).strip().splitlines()[-1][:300]}), flush=True)
    print(json.dumps({"card": card["name"], "power_limit": card["power_limit"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
