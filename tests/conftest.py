"""Test configuration: run JAX on a virtual 8-device CPU mesh.

A pytest process that starts before JAX is imported (the normal case)
is pinned to the CPU backend with 8 virtual devices, and its env is set
before jax is imported anywhere (SURVEY.md section 7.4: distributed
tests use XLA's multi-device CPU simulation). When pytest runs inside a
process that already holds the GPU (``chip_smoke.py`` runs the tests
marked ``gpu`` that way), the backend is left as it is.

Tests marked ``gpu`` run only where JAX's backend is the GPU; anywhere
else they skip with a reason. The check is made in a fixture, per test,
never at import, so every xdist worker collects the same tests.
"""

import os
import sys

if "jax" not in sys.modules:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    # Persistent compilation cache: XLA-CPU compiles of the conv-heavy
    # jitted pipelines dominate test wall-clock; cache them across runs.
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

import jax  # noqa: E402

from pyfeaturetrack_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Periodic jax.clear_caches(): every compiled XLA-CPU executable the
# session-long jit caches keep alive holds ~177 mmap regions; the full
# suite accumulates ~65k mappings and the NEXT compile segfaults when
# it trips vm.max_map_count (65530) — measured 2026-08-18 with the
# PFT_RESMON logger below (maps 1,024 -> 65,433 over 367 tests, then
# SIGSEGV inside backend_compile_and_load, deterministically at ~92% of
# the suite). Clearing every 20 tests caps the census at a few
# thousand; the persistent compilation cache (above) makes the
# recompiles cheap. PFT_CLEAR_CACHES=0 disables, =N changes the period.
#
# PFT_RESMON=/path/to/log (opt-in) appends "<maps> <VmRSS kB>
# <VmSize kB> <test id>" after every test — the instrument that
# localized the leak; kept for future resource chases.
_RESMON = os.environ.get("PFT_RESMON")
_CLEAR_EVERY = int(os.environ.get("PFT_CLEAR_CACHES", "20"))
_test_counter = [0]


def pytest_runtest_teardown(item):
    _test_counter[0] += 1
    if _CLEAR_EVERY and _test_counter[0] % _CLEAR_EVERY == 0:
        jax.clear_caches()
    if _RESMON:
        with open("/proc/self/status") as f:
            d = dict(line.split(":", 1) for line in f if ":" in line)
        with open("/proc/self/maps") as f:
            maps = sum(1 for _ in f)
        with open(_RESMON, "a") as f:
            f.write(f"{maps} {d['VmRSS'].split()[0]} "
                    f"{d['VmSize'].split()[0]} {item.nodeid}\n")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip tests marked ``gpu`` unless JAX's backend is the GPU."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs the GPU: the compiled CUDA kernel has no "
                    f"CPU lowering (backend is {jax.default_backend()})")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


def make_textured_image(nrows, ncols, seed=0, smooth=True):
    """Synthetic textured test image with rich gradients, values 0..255."""
    r = np.random.default_rng(seed)
    img = r.uniform(0, 255, size=(nrows, ncols))
    if smooth:
        # cheap separable binomial smoothing to create trackable structure
        k = np.array([1, 4, 6, 4, 1], dtype=np.float64)
        k /= k.sum()
        for axis in (0, 1):
            img = np.apply_along_axis(
                lambda m: np.convolve(m, k, mode="same"), axis, img)
    lo, hi = img.min(), img.max()
    img = (img - lo) / (hi - lo) * 255.0
    return np.floor(img).astype(np.float64)


def shift_image_bilinear(img, dx, dy):
    """Translate an image by (dx, dy) with bilinear resampling (for synthetic
    known-flow pairs). Edges replicate."""
    nrows, ncols = img.shape
    ys, xs = np.mgrid[0:nrows, 0:ncols].astype(np.float64)
    xs = np.clip(xs - dx, 0, ncols - 1)
    ys = np.clip(ys - dy, 0, nrows - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, ncols - 2)
    y0 = np.clip(np.floor(ys).astype(int), 0, nrows - 2)
    ax, ay = xs - x0, ys - y0
    return ((1 - ax) * (1 - ay) * img[y0, x0] +
            ax * (1 - ay) * img[y0, x0 + 1] +
            (1 - ax) * ay * img[y0 + 1, x0] +
            ax * ay * img[y0 + 1, x0 + 1])


@pytest.fixture(scope="session")
def textured_image():
    return make_textured_image(120, 160, seed=3)
