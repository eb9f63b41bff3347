"""Build-time recentering for far-from-origin scenes (Scene.world_offset).

The matmul-expanded sphere quadratic (|o|^2 - 2 o.c + |c|^2 - r^2,
ops/intersect.py sphere_ts) cancels catastrophically in f32 once scene
coordinates pass ~1e3 with unit-scale features. SceneBuilder folds the
centroid out of the geometry above RECENTER_THRESHOLD; a translated copy of
a scene must therefore render the same image as the origin-centered one.
"""

import jax
import numpy as np
import pytest

from cpu_ray_tracing_implementation_tpu.models import camera as cam_mod
from cpu_ray_tracing_implementation_tpu.models import integrator
from cpu_ray_tracing_implementation_tpu.models.scene import SceneBuilder

# offset chosen as a multiple of the checker period (2 * scale) so the
# position-based ground texture is translation-invariant too
OFFSET = np.array([10000.0, 0.0, 10000.0])


def _three_ball(offset):
    b = SceneBuilder()
    ground = b.lambertian(b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9), 1.0))
    b.sphere(offset + (0, -1000, 0), 1000.0, ground)
    b.sphere(offset + (0, 1, 0), 1.0, b.lambertian((0.4, 0.2, 0.1)))
    b.sphere(offset + (4, 1, 0), 1.0, b.metal((0.7, 0.6, 0.5), 0.0))
    b.sphere(offset + (-4, 1, 0), 1.0, b.dielectric(1.5))
    b.set_background(b.solid((0.7, 0.8, 1.0)))
    camera = cam_mod.perspective(
        32, 1.0, tuple(offset + (13, 2, 3)), tuple(offset + (0, 0, 0)),
        1.0, 25.0, 2, 4)
    return b.build(), camera


def test_centered_scene_not_recentered():
    scene, _ = _three_ball(np.zeros(3))
    assert scene.world_offset is None


def test_translated_scene_is_recentered():
    scene, _ = _three_ball(OFFSET)
    assert scene.world_offset is not None
    # the folded geometry is back near the origin
    assert float(np.abs(np.asarray(scene.spheres.c0)).max()) < 2000.0


def test_translated_render_matches_centered():
    """A scene translated by ~1e4 renders the same image as at the origin
    (same per-pixel RNG; geometry differs only by the folded offset)."""
    scene0, cam0 = _three_ball(np.zeros(3))
    scene1, cam1 = _three_ball(OFFSET)
    key = jax.random.key(0)
    img0 = np.asarray(integrator.render_image(scene0, cam0, key, spp=2))
    img1 = np.asarray(integrator.render_image(scene1, cam1, key, spp=2))
    assert np.isfinite(img1).all()
    # identical RNG streams + f32-identical shifted geometry: tiny numeric
    # jitter only (no catastrophic-cancellation artifacts)
    np.testing.assert_allclose(img1.mean(), img0.mean(), atol=5e-3)
    assert np.abs(img1 - img0).mean() < 5e-3
    # fewer than 2% of pixels may differ visibly (edge-sample decision flips)
    assert (np.abs(img1 - img0).max(axis=-1) > 0.05).mean() < 0.02
