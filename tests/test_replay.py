"""Compact-residual intersection for the gradient path (ops/replay.py).

The dense sweep's min/argmin already routes gradients to the winning
primitive only, so replaying that one primitive computes the same
derivative while the remat backward stores 4 bytes per lane-bounce and
skips the O(R*N) recompute + transposed sweep. Tests: Hit parity vs the
brute oracle, render parity, gradient parity vs the remat-everything VJP,
finite differences, and composition with NEE/volumes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpu_ray_tracing_implementation_tpu.models import catalog, diff, integrator
from cpu_ray_tracing_implementation_tpu.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu.ops import materials as mat_ops
from cpu_ray_tracing_implementation_tpu.ops import replay


SCENES = [
    ("cornell_box", lambda: catalog.cornell_box(width=16, spp=2, max_depth=3)),
    ("three_material_ball",
     lambda: catalog.three_material_ball(width=16, spp=2, max_depth=3)),
    ("cornell_box_with_volume",
     lambda: catalog.cornell_box_with_volume(width=12, spp=2, max_depth=3)),
    ("random_motion_ball",
     lambda: catalog.random_motion_ball(width=10, spp=2, max_depth=3)),
]


def _rays(scene, cam, n=512, seed=0):
    from cpu_ray_tracing_implementation_tpu.models import camera as cam_mod

    key = jax.random.key(seed)
    pix = jnp.arange(n, dtype=jnp.int32) % (cam.width * cam.height)
    u_cam = jax.random.uniform(key, (n, cam_mod.N_CAM_SLOTS))
    org, dirs, time = cam_mod.generate_rays(cam, pix, u_cam)
    u_vol = jax.random.uniform(jax.random.fold_in(key, 1),
                               (n, scene.n_volumes))
    return org, dirs, time, u_vol


@pytest.mark.parametrize("name,mk", SCENES, ids=[s[0] for s in SCENES])
def test_replay_hit_matches_brute(name, mk):
    """intersect_replay reproduces intersect_brute's Hit on camera rays
    (values to fp tolerance; decisions exactly)."""
    scene, cam = mk()
    if not replay.supported(scene):
        pytest.skip("chunked scene")
    org, dirs, time, u_vol = _rays(scene, cam)
    hb = isect.intersect_brute(scene, org, dirs, time, 1e-3, u_vol)
    hr = replay.intersect_replay(scene, org, dirs, time, 1e-3, u_vol)
    np.testing.assert_array_equal(np.asarray(hr.valid), np.asarray(hb.valid))
    v = np.asarray(hb.valid)
    # miss lanes carry don't-care attrs (brute: leftovers of its masked
    # merge; replay: defaults) — the integrator discards both via `lit`
    np.testing.assert_array_equal(np.asarray(hr.mat)[v],
                                  np.asarray(hb.mat)[v])
    np.testing.assert_array_equal(np.asarray(hr.front)[v],
                                  np.asarray(hb.front)[v])
    # t agrees to ~1e-4 relative (the dense matmul expansion of |o-c|^2
    # cancels in f32; replay's direct form is the tighter one). Derived
    # attrs amplify that by |dir|/radius — e.g. normal err ~ t_err*|d|/0.2
    # on the motion-ball's small spheres — hence the looser bounds below.
    np.testing.assert_allclose(np.asarray(hr.t)[v], np.asarray(hb.t)[v],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(hr.p)[v], np.asarray(hb.p)[v],
                               rtol=1e-3, atol=5e-3)
    np.testing.assert_allclose(np.asarray(hr.normal)[v],
                               np.asarray(hb.normal)[v],
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(np.asarray(hr.u)[v], np.asarray(hb.u)[v],
                               rtol=5e-2, atol=5e-2)


def test_replay_render_close_to_default():
    """A replay-intersect render agrees with the default render to fp noise
    (decisions identical; values differ in ulps from the re-associated
    winner arithmetic)."""
    scene, cam = catalog.cornell_box(width=16, spp=4, max_depth=3)
    key = jax.random.key(0)
    base = np.asarray(integrator.render_image(scene, cam, key, spp=4,
                                              unroll=(1, 1)))
    rep = np.asarray(integrator.render_image(scene, cam, key, spp=4,
                                             unroll=(1, 1),
                                             replay_isect=True))
    np.testing.assert_allclose(rep, base, rtol=2e-3, atol=2e-3)


def test_replay_grads_match_remat_everything():
    """loss_and_grads under replay equals the remat-everything VJP.
    ``replay`` is an explicit STATIC arg (separate jit cache entries) —
    an env-var flip between same-shape calls would silently reuse the
    first trace and compare a path against itself."""
    scene, cam = catalog.cornell_box(width=12, spp=2, max_depth=3)
    target = jnp.zeros((cam.height, cam.width, 3))
    key = jax.random.key(3)

    l0, (gs0, gc0) = diff.loss_and_grads(scene, cam, key, target, spp=2,
                                         replay=False)
    l1, (gs1, gc1) = diff.loss_and_grads(scene, cam, key, target, spp=2,
                                         replay=True)

    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-4)
    for k in gs0:
        np.testing.assert_allclose(np.asarray(gs1[k]), np.asarray(gs0[k]),
                                    rtol=2e-3, atol=1e-5, err_msg=k)
    for k in gc0:
        np.testing.assert_allclose(np.asarray(gc1[k]), np.asarray(gc0[k]),
                                    rtol=5e-3, atol=1e-4, err_msg=k)


def test_replay_grads_match_finite_differences():
    """Albedo gradient through the replay path matches central FD of the
    replay loss (the BASELINE.md gradient-validity metric)."""
    scene, cam = catalog.cornell_box(width=10, spp=2, max_depth=2)
    target = jnp.zeros((cam.height, cam.width, 3))
    key = jax.random.key(5)
    _, (gs, _) = diff.loss_and_grads(scene, cam, key, target, spp=2)

    eps = 1e-2
    row, col = 1, 0  # a wall albedo entry
    c0 = scene.textures.color0

    def loss_at(v):
        s = scene.replace(textures=scene.textures.replace(
            color0=c0.at[row, col].set(v)))
        return float(diff.image_loss(s, cam, key, target, spp=2))

    v0 = float(c0[row, col])
    fd = (loss_at(v0 + eps) - loss_at(v0 - eps)) / (2 * eps)
    ad = float(gs["tex_color0"][row, col])
    assert abs(ad - fd) <= 2e-2 * max(abs(fd), 1e-3), (ad, fd)


def test_replay_nee_gradients_finite():
    """Replay composes with NEE's shadow-ray intersect."""
    scene, cam = catalog.cornell_box(width=10, spp=2, max_depth=2)
    target = jnp.zeros((cam.height, cam.width, 3))
    loss, (gs, _) = diff.loss_and_grads(scene, cam.replace(nee=True),
                                        jax.random.key(0), target, spp=2)
    assert np.isfinite(float(loss))
    for k, g in gs.items():
        assert np.isfinite(np.asarray(g)).all(), k
    assert float(np.abs(np.asarray(gs["tex_color0"])).sum()) > 0.0


def test_replay_volume_grads_finite():
    """Volume winners replay through the -ln(U)/rho path with finite
    gradients — INCLUDING camera grads through dirs (the log floor must be
    a normal f32: XLA flushes subnormals, and the resulting -inf poisons
    masked lanes' camera gradients with 0 * inf)."""
    scene, cam = catalog.cornell_box_with_volume(width=10, spp=2,
                                                 max_depth=3)
    target = jnp.zeros((cam.height, cam.width, 3))
    loss, (gs, gc) = diff.loss_and_grads(scene, cam, jax.random.key(1),
                                         target, spp=2)
    assert np.isfinite(float(loss))
    for k, g in {**gs, **gc}.items():
        assert np.isfinite(np.asarray(g)).all(), k
