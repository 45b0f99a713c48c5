"""The port's native bridge (``engine/native_bridge.py``, ``native/allocator.cc``
built with g++ into the port's build directory) held to the cases of
``tests/test_native.py``, and the port's scheduler on the C++ lane table
against the same scheduler on its Python lane scan."""

import ctypes

import numpy as np
import pytest
import torch

from adaptive_sd_tpu_torch.core.exceptions import ResourceError
from adaptive_sd_tpu_torch.engine import ContinuousBatchingScheduler, TierEngine
from adaptive_sd_tpu_torch.engine import native_bridge as nb
from adaptive_sd_tpu_torch.engine.allocator import PageAllocator
from adaptive_sd_tpu_torch.engine.native_bridge import (
    NativeLanes,
    NativePageAllocator,
    load_native,
    make_lanes,
    make_page_allocator,
)
from adaptive_sd_tpu_torch.models import TINY
from tests.test_torch_common import tiny_weights

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def native():
    """The library, built with g++ at first use."""
    lib = load_native()
    assert lib is not None, nb.build_error()
    return lib


class TestNativeAllocator:
    def test_equivalence_with_python(self):
        """Drive both allocators through an identical op sequence."""
        py, nat = PageAllocator(32), NativePageAllocator(32)
        for alloc in (py, nat):
            assert len(alloc.alloc("a", 4)) == 4
            assert len(alloc.ensure("a", 6)) == 6
            assert len(alloc.ensure("b", 3)) == 3
            assert alloc.free_from("a", 2) == 4
            assert len(alloc.pages_of("a")) == 2
            assert alloc.free_request("b") == 3
        ps, ns = py.stats(), nat.stats()
        assert (ps.n_pages, ps.free_pages, ps.active_requests) == (
            ns.n_pages, ns.free_pages, ns.active_requests)
        assert ps.peak_used == ns.peak_used

    def test_oom_raises_and_counts(self):
        nat = NativePageAllocator(4)
        nat.alloc("r", 3)
        with pytest.raises(ResourceError):
            nat.alloc("r2", 2)
        assert nat.stats().failed_allocs == 1
        assert nat.stats().free_pages == 1  # no partial allocation happened

    def test_pages_are_unique(self):
        nat = NativePageAllocator(16)
        assert len(set(nat.alloc("a", 8)) | set(nat.alloc("b", 8))) == 16

    def test_factory_prefers_native(self):
        assert isinstance(make_page_allocator(8), NativePageAllocator)
        assert isinstance(make_page_allocator(8, prefer_native=False), PageAllocator)


def _scan_buffers(n=4):
    return ((ctypes.c_int32 * n)(), ctypes.c_int64(), (ctypes.c_int32 * n)(),
            (ctypes.c_int32 * n)(), (ctypes.c_int32 * n)(), (ctypes.c_uint8 * n)())


class TestNativeLanes:
    def _lanes(self, n=4, page=16):
        lib = load_native()
        return lib, ctypes.c_void_p(lib.asd_lanes_create(n, page))

    def test_admit_step_retire_cycle(self):
        lib, h = self._lanes()
        assert lib.asd_lanes_admit(h, 10, 3, 42) == 0  # position 10, budget 3, token 42
        assert lib.asd_lanes_admit(h, 5, 2, 7) == 1
        finished, nf, active, toks, pos, needs = _scan_buffers()
        na = lib.asd_lanes_step_prepare(h, -1, finished, ctypes.byref(nf), active, toks, pos,
                                        needs)
        assert na == 2 and nf.value == 0
        assert toks[0] == 42 and pos[0] == 10
        # advance lane 0 twice -> hits budget 3 (admission counted one)
        lib.asd_lanes_advance(h, 0, 43)
        lib.asd_lanes_advance(h, 0, 44)
        na = lib.asd_lanes_step_prepare(h, -1, finished, ctypes.byref(nf), active, toks, pos,
                                        needs)
        assert nf.value == 1 and finished[0] == 0
        assert na == 1 and active[0] == 1
        lib.asd_lanes_release(h, 0)
        assert lib.asd_lanes_admit(h, 0, 1, 1) == 0  # lane reusable

    def test_eos_detection(self):
        lib, h = self._lanes()
        lib.asd_lanes_admit(h, 4, 100, 99)
        finished, nf, active, toks, pos, needs = _scan_buffers()
        na = lib.asd_lanes_step_prepare(h, 99, finished, ctypes.byref(nf), active, toks, pos,
                                        needs)
        assert nf.value == 1 and na == 0

    def test_page_boundary_flag(self):
        lib, h = self._lanes(page=16)
        lib.asd_lanes_admit(h, 15, 10, 5)  # next write at 15 -> crosses at 16
        finished, nf, active, toks, pos, needs = _scan_buffers()
        lib.asd_lanes_step_prepare(h, -1, finished, ctypes.byref(nf), active, toks, pos, needs)
        assert needs[0] == 1


def test_build_goes_to_the_port_build_dir():
    """The port builds its own library and never loads the JAX side's."""
    assert nb.LIB_PATH.parent == nb.BUILD_DIR and nb.LIB_PATH.exists()
    assert nb.BUILD_DIR.parent.name == "adaptive_sd_tpu_torch"
    assert nb.SOURCE.name == "allocator.cc" and nb.SOURCE.parent.name == "native"
    assert isinstance(make_lanes(4, 16), NativeLanes)
    assert make_lanes(4, 16, prefer_native=False) is None


PROMPTS = [[3, 14, 15], [9, 2, 6, 5], [7, 8, 9, 1, 2], [4, 4], [11, 12, 13, 14, 15, 16, 17]]


@pytest.fixture(scope="module")
def engines():
    """Port engines over TINY weights: a roomy pool and a 4-page one."""
    tp = tiny_weights(0)[1]
    return tuple(TierEngine(TINY, tp, device="cpu", page_size=16, n_pages=n) for n in (128, 4))


@pytest.mark.parametrize("kw", [dict(), dict(scan_steps=4), dict(scan_steps=4, device_carry=False)],
                         ids=["step", "scan", "scan_legacy"])
@pytest.mark.parametrize("pool", ["roomy", "tight"])
def test_scheduler_on_native_lanes_equals_python_scan(engines, kw, pool, monkeypatch):
    """The same submissions through the port's scheduler on the C++ lane
    table and on the Python scan: the same tokens, logprobs, positions,
    preemptions and dispatch counts (a 4-page pool preempts)."""
    eng = engines[0] if pool == "roomy" else engines[1]
    budgets = [12, 5, 9, 3, 7] if pool == "roomy" else [30, 30]
    prompts = PROMPTS if pool == "roomy" else PROMPTS[:2]
    runs = []
    for native in (True, False):
        if not native:
            monkeypatch.setattr(nb, "make_lanes", lambda *a, **k: None)
        sched = ContinuousBatchingScheduler(eng, max_batch=2, **kw)
        assert (sched._nlanes is not None) == native
        reqs = [sched.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
        sched.run_until_idle()
        assert eng.allocator.stats().active_requests == 0
        runs.append((reqs, sched))
    (nreqs, nsched), (preqs, psched) = runs
    for a, b in zip(nreqs, preqs):
        assert a.done and b.done and a.error is None and b.error is None, (a.error, b.error)
        assert a.out_tokens == b.out_tokens and a.position == b.position
        np.testing.assert_array_equal(a.out_logprobs, b.out_logprobs)
        assert a.preemptions == b.preemptions
    assert {k: v[0] for k, v in nsched._disp.items()} == {k: v[0] for k, v in psched._disp.items()}
    if pool == "tight":
        assert sum(r.preemptions for r in nreqs) > 0
