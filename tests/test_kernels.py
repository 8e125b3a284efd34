"""Unit tests for core SPH kernel math vs. the independent NumPy oracle."""

import numpy as np
import jax.numpy as jnp

from rust_particle_system.core import kernels as K
from rust_particle_system.core.params import make_params, kernel_norms

import numpy_oracle as oracle


def _params(**kw):
    return oracle.Params(**kw)


def test_kernel_norms_match_reference_formulas():
    dn, nn, vn = kernel_norms(9.0)
    assert np.isclose(dn, 10.0 / (np.pi * 9.0**5))
    assert np.isclose(nn, 15.0 / (np.pi * 9.0**6))
    assert np.isclose(vn, 4.0 / (np.pi * 9.0**8))


def test_smoothing_kernels_vs_oracle():
    p = _params()
    ds = np.linspace(0.0, 2.0 * p.h, 101)
    fns = [
        (K.density_kernel, oracle.density_kernel, p.dn),
        (K.density_kernel_derivative, oracle.density_kernel_derivative, p.dn),
        (K.near_density_kernel, oracle.near_density_kernel, p.nn),
        (K.near_density_kernel_derivative, oracle.near_density_kernel_derivative, p.nn),
        (K.viscosity_kernel, oracle.viscosity_kernel, p.vn),
    ]
    for jax_fn, np_fn, norm in fns:
        got = np.asarray(jax_fn(jnp.asarray(ds, jnp.float32), p.h, norm))
        want = np.array([np_fn(float(d), p) for d in ds])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


def test_kernels_zero_at_and_beyond_radius():
    p = _params()
    for d in [p.h, p.h * 1.0001, p.h * 10]:
        assert float(K.density_kernel(d, p.h, p.dn)) == 0.0
        assert float(K.near_density_kernel(d, p.h, p.nn)) == 0.0
        assert float(K.viscosity_kernel(d, p.h, p.vn)) == 0.0
        assert float(K.density_kernel_derivative(d, p.h, p.dn)) == 0.0
        assert float(K.near_density_kernel_derivative(d, p.h, p.nn)) == 0.0


def test_bounce_bounds_forces_sign_and_damps():
    bounds = jnp.asarray([-10.0, 10.0, -5.0, 5.0], jnp.float32)
    pos = jnp.asarray([[-12.0, 0.0], [12.0, 0.0], [0.0, -6.0], [0.0, 6.0], [0.0, 0.0]])
    # inward-pointing velocity at the wall is still forced to the bounce sign (abs),
    # matching compute_shader.wgsl:80-95
    vel = jnp.asarray([[5.0, 1.0], [5.0, 1.0], [1.0, 3.0], [1.0, 3.0], [9.0, 9.0]])
    new_pos, new_vel = K.bounce_bounds(pos, vel, bounds, 0.1)
    np.testing.assert_allclose(
        np.asarray(new_pos),
        [[-10, 0], [10, 0], [0, -5], [0, 5], [0, 0]],
    )
    np.testing.assert_allclose(
        np.asarray(new_vel),
        [[0.5, 1.0], [-0.5, 1.0], [1.0, 0.3], [1.0, -0.3], [9.0, 9.0]],
        rtol=1e-6,
    )


def test_energy_color_ramp_endpoints_and_midpoint():
    max_e = 2000.0
    # zero velocity -> blue; mid energy -> green; >= max energy -> red
    v0 = jnp.zeros((1, 2))
    vmid = jnp.asarray([[np.sqrt(max_e), 0.0]])  # 0.5*v^2 = 0.5*max_e -> t = 0.5
    vhot = jnp.asarray([[np.sqrt(4 * max_e), 0.0]])  # t clamps to 1
    np.testing.assert_allclose(np.asarray(K.energy_color(v0, max_e))[0], [0, 0, 1, 1])
    np.testing.assert_allclose(
        np.asarray(K.energy_color(vmid, max_e))[0], [0, 1, 0, 1], atol=1e-5
    )
    np.testing.assert_allclose(np.asarray(K.energy_color(vhot, max_e))[0], [1, 0, 0, 1])


def test_params_pytree_roundtrip():
    import jax

    p = make_params()
    leaves, treedef = jax.tree.flatten(p)
    p2 = jax.tree.unflatten(treedef, leaves)
    assert float(p2.smoothing_radius) == 9.0
    assert np.isclose(float(p2.dt), 0.01)
    assert int(p2.shader_delay) == 5
