"""Platform decisions, in one place.

* which SPH and N-body path ``backend="auto"`` takes: on a GPU the Pallas-Triton
  kernels (the measured choice, ``PERF.md`` "Kernel choices at bring-up"), on the CPU
  the plain XLA paths; any other platform is an error;
* that a Pallas kernel runs compiled unless its caller passes ``interpret=True``
  (nothing infers the interpreter from the backend);
* where the persistent compile cache lives.
"""

from __future__ import annotations

import os

import jax

# backend="auto" per platform and model family.
AUTO_BACKENDS = {
    "gpu": {"sph": "pallas", "nbody": "pallas"},
    "cpu": {"sph": "grid", "nbody": "jnp"},
}
# Backends that run a Pallas-Triton kernel (compiled only for a GPU).
KERNEL_BACKENDS = {"sph": ("pallas",), "nbody": ("pallas",)}

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


def platform() -> str:
    return jax.default_backend()


def auto_backend(family: str) -> str:
    """The path ``backend="auto"`` takes for ``family`` on this platform."""
    p = platform()
    if p not in AUTO_BACKENDS:
        raise RuntimeError(f"unsupported platform {p!r}: expected one of "
                           f"{sorted(AUTO_BACKENDS)}")
    return AUTO_BACKENDS[p][family]


def resolve_backend(family: str, backend: str, interpret: bool = False) -> str:
    """Resolve ``"auto"`` and refuse a kernel backend that cannot run here."""
    if backend == "auto":
        backend = auto_backend(family)
    if backend in KERNEL_BACKENDS[family]:
        check_kernel_platform(interpret)
    return backend


def check_kernel_platform(interpret: bool) -> None:
    """Pallas-Triton kernels compile only for a GPU; elsewhere the caller must ask
    for the interpreter explicitly."""
    if not interpret and platform() != "gpu":
        raise RuntimeError(
            f"the Pallas-Triton kernels compile only for a GPU (platform is "
            f"{platform()!r}); pass interpret=True to run them in the Pallas "
            f"interpreter, or choose the XLA backend"
        )


def require_gpu(what: str):
    """The first device, or SystemExit when JAX finds no GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"{what}: no GPU found (JAX platform is {dev.platform!r})")
    return dev


def enable_compile_cache() -> str:
    """Use ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself and
    nothing else is set here); otherwise ``<checkout>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
