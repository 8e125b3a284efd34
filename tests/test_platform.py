"""The platform module: backend="auto", the interpreter flag, the compile cache,
and the entry points that refuse to run without a GPU."""

import inspect
import os
import subprocess
import sys

import pytest

from rust_particle_system import platform
from rust_particle_system.models import NBody, SPHFluid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDS = (-96.0, 96.0, -54.0, 54.0)


@pytest.mark.parametrize("name,sph,nbody", [
    ("gpu", "pallas", "pallas"), ("cpu", "grid", "jnp"),
])
def test_auto_backend_per_platform(monkeypatch, name, sph, nbody):
    monkeypatch.setattr(platform, "platform", lambda: name)
    assert platform.auto_backend("sph") == sph
    assert platform.auto_backend("nbody") == nbody


def test_auto_backend_refuses_unknown_platform(monkeypatch):
    monkeypatch.setattr(platform, "platform", lambda: "metal")
    with pytest.raises(RuntimeError, match="unsupported platform"):
        platform.auto_backend("sph")
    with pytest.raises(RuntimeError, match="unsupported platform"):
        SPHFluid.create(n=64, bounds=BOUNDS)


def test_models_take_the_cpu_path_here():
    assert SPHFluid.create(n=64, bounds=BOUNDS).backend == "grid"
    assert NBody.create().backend == "jnp"


@pytest.mark.parametrize("make", [
    lambda: SPHFluid.create(n=64, bounds=BOUNDS, backend="pallas"),
    lambda: NBody.create(backend="pallas"),
])
def test_kernel_backends_refuse_cpu_without_interpret(make):
    with pytest.raises(RuntimeError, match="interpret=True"):
        make()


def test_sharded_step_refuses_cpu_without_interpret():
    from rust_particle_system.parallel import (
        make_band_mesh,
        make_shard_spec,
        make_sharded_step,
    )

    spec = make_shard_spec(BOUNDS, 9.0, n=64, n_bands=2)
    with pytest.raises(RuntimeError, match="interpret=True"):
        make_sharded_step(spec, make_band_mesh(2))
    make_sharded_step(spec, make_band_mesh(2), interpret=True)  # explicit: fine


def test_interpret_is_never_inferred():
    """Every kernel entry point defaults to compiled; only callers opt in."""
    from rust_particle_system.ops.pallas import nbody, sph_walk
    from rust_particle_system.parallel import sharded_step

    for fn in (sph_walk.density_walk, sph_walk.force_walk, sph_walk.walk_quantities,
               sph_walk.walk_physics, sph_walk.walk_step, nbody.nbody_accel_pallas,
               sharded_step.make_sharded_step, SPHFluid.create, NBody.create):
        fn = getattr(fn, "__wrapped__", fn)
        assert inspect.signature(fn).parameters["interpret"].default is False, fn
    assert SPHFluid.create(n=64, bounds=BOUNDS, backend="pallas",
                           interpret=True).interpret is True


def _python(code, env_extra=None, cwd=REPO, timeout=240):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO})
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


_CACHE_PROBE = """
import jax, jax.numpy as jnp
from rust_particle_system import platform
used = platform.enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.jit(lambda x: jnp.sin(x) * 3.0 + 1.0)(jnp.arange(7.0)).block_until_ready()
print(used)
print(jax.config.jax_compilation_cache_dir)
"""


def test_compile_cache_honours_env_var(tmp_path):
    cache = tmp_path / "cache"
    r = _python(_CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": str(cache)},
                cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    used, configured = r.stdout.split()[-2:]
    assert used == configured == str(cache)
    assert cache.is_dir() and any(cache.iterdir())  # entries land there


def test_compile_cache_default_is_fixed_checkout_path(tmp_path):
    r = _python(_CACHE_PROBE.replace("jax.jit(", "0 and jax.jit("), cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    used, configured = r.stdout.split()[-2:]
    assert used == configured == os.path.join(REPO, ".jax_cache")
    assert platform.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py", "bench_multichip.py"])
def test_gpu_entry_points_fail_without_a_gpu(script):
    r = subprocess.run([sys.executable, script], cwd=REPO, capture_output=True,
                       text=True, timeout=240,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert "no GPU found" in (r.stdout + r.stderr)
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=240, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
