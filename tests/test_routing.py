"""Backend routing, device checks and cache placement — the decisions
that pick what runs on the card, exercised on the CPU with the platform
patched inside each test."""

import os

import jax
import pytest

from sharp_tpu.ops import linkage
from sharp_tpu.ops.linkage import resolve_linkage_backend

HMETHODS = ("ward.D2", "single", "complete", "average", "mcquitty",
            "median", "centroid")


@pytest.fixture
def platform(monkeypatch):
    def set_platform(name):
        monkeypatch.setattr(linkage, "_platform", lambda: name)
    return set_platform


@pytest.mark.parametrize("plat,want", [("gpu", "rnn"), ("cpu", "xla")])
def test_auto_ward_routing(platform, plat, want):
    """ward.D on the GPU takes the f32 ladder (PERF.md, "Bring-up
    findings"); the CPU keeps the serial loop."""
    platform(plat)
    assert resolve_linkage_backend("auto") == want


@pytest.mark.parametrize("hmethod", HMETHODS)
@pytest.mark.parametrize("plat", ["gpu", "cpu"])
def test_auto_non_ward_is_serial(platform, plat, hmethod):
    platform(plat)
    assert resolve_linkage_backend("auto", hmethod) == "xla"


@pytest.mark.parametrize("backend", ["xla", "rnn", "rnn_bf16"])
def test_explicit_backend_kept_on_any_platform(platform, backend):
    for plat in ("gpu", "cpu"):
        platform(plat)
        assert resolve_linkage_backend(backend) == backend


@pytest.mark.parametrize("backend", ["pallas", "pallas_bf16", "mosaic"])
def test_removed_backends_raise(backend):
    with pytest.raises(ValueError, match="unknown linkage backend"):
        resolve_linkage_backend(backend)


def test_ladder_with_non_ward_raises():
    with pytest.raises(ValueError, match="ward.D only"):
        resolve_linkage_backend("rnn", "average")


@pytest.mark.parametrize("plat,want", [("gpu", True), ("cpu", False)])
def test_cut_kernel_only_on_gpu(platform, monkeypatch, plat, want):
    """opt_hclust replays its cuts in the Triton kernel exactly when it
    runs on the GPU; here the kernel runs in interpret mode, and both
    routes must pick the same cut."""
    import functools

    import jax.numpy as jnp
    import numpy as np

    from sharp_tpu.ops import cutree_pallas
    from sharp_tpu.ops.select import opt_hclust

    calls = []
    real_kernel = cutree_pallas.cutree_multi_pallas

    def kernel(*a, **kw):
        calls.append(1)
        return real_kernel(*a, interpret=True, **kw)

    rng = np.random.default_rng(3)
    n_pad, n_real = 32, 30
    feats = np.zeros((n_pad, 8), np.float32)
    feats[:n_real] = (rng.normal(size=(3, 8)) * 4)[rng.integers(0, 3, n_real)]
    feats[:n_real] += rng.normal(size=(n_real, 8))
    args = (jnp.asarray(feats), jnp.arange(n_pad) < n_real,
            jnp.asarray(n_real), jnp.asarray(10))
    kw = dict(symmetric=False, minN=2, ncand=9, nc_pad=16,
              linkage_backend="xla")
    want_res = opt_hclust(*args, **kw)

    platform(plat)
    monkeypatch.setattr(cutree_pallas, "cutree_multi_pallas", kernel)
    # a fresh jit of the same function, so the route is traced anew
    got = jax.jit(functools.partial(opt_hclust.__wrapped__, **kw))(*args)
    assert bool(calls) is want
    for field in ("all_labels", "labels", "k"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want_res, field)))


def test_platform_follows_default_device():
    """A computation placed on the CPU device of a GPU process must not
    route to GPU-only kernels."""
    with jax.default_device(jax.devices("cpu")[0]):
        assert linkage._platform() == "cpu"
    assert linkage._platform() == jax.default_backend()


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    from sharp_tpu.utils import cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    assert cache.compilation_cache_dir() == str(tmp_path / "jc")


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    from sharp_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = cache.compilation_cache_dir()
    assert d == os.path.join(cache.REPO_ROOT, ".cache", "jax")
    assert os.path.isdir(d)
    # the checkout's .gitignore keeps it out of commits
    with open(os.path.join(cache.REPO_ROOT, ".gitignore")) as fh:
        assert ".cache/" in fh.read().split()


def test_resolve_mesh_raises_when_devices_missing():
    from sharp_tpu.config import resolve_config
    from sharp_tpu.parallel.mesh import resolve_mesh

    cfg = resolve_config(1000, 50, n_devices=len(jax.devices()) + 1)
    with pytest.raises(ValueError, match="devices are visible"):
        resolve_mesh(cfg)
    assert resolve_mesh(cfg.replace(n_devices=1)) is None


def test_memory_budget_refuses_a_device_without_stats(monkeypatch):
    from sharp_tpu.parallel import sharded

    class FakeGpu:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

        def memory_stats(self):
            return None

    monkeypatch.delenv("SHARP_TPU_HBM_BUDGET", raising=False)
    monkeypatch.setattr(sharded.jax, "local_devices", lambda: [FakeGpu()])
    with pytest.raises(RuntimeError, match="no memory limit"):
        sharded.hbm_budget_bytes()


def test_memory_budget_on_cpu_is_fixed(monkeypatch):
    from sharp_tpu.parallel import sharded

    monkeypatch.delenv("SHARP_TPU_HBM_BUDGET", raising=False)
    assert sharded.hbm_budget_bytes() == 8 << 30
