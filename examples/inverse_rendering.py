"""Inverse rendering: recover an unknown sphere albedo from a target image.

Renders a lambertian sphere with the true albedo as the optimization
target, restarts from grey, and gradient-descends back (models/diff.py
detached-sampling estimator — a capability the CUDA/C++ reference has no
analogue for). Converges to ~0.05 absolute albedo error in under a
minute on CPU, seconds on a GPU.

    python examples/inverse_rendering.py [--steps 80] [--spp 4]

For a harder problem (a Cornell-box wall lit only indirectly), raise
--width/--spp and expect a few hundred steps; diff.fit_scene's grad_mask
keeps the light's emission row frozen while a wall row optimizes.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import numpy as np

from cpu_ray_tracing_implementation_tpu.models import camera as cam_mod
from cpu_ray_tracing_implementation_tpu.models import diff, integrator
from cpu_ray_tracing_implementation_tpu.models.scene import SceneBuilder


TRUE_ALBEDO = (0.8, 0.2, 0.5)


def build(albedo):
    b = SceneBuilder()
    b.sphere((0, 0, -3), 1.0, b.lambertian(albedo))
    b.set_background(b.solid((1.0, 1.0, 1.0)))
    cam = cam_mod.perspective(64, 1.0, (0, 0, 0), (0, 0, -1), 1.0, 60.0,
                              4, 3)
    return b.build(), cam


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--steps", type=int, default=80)
    p.add_argument("--lr", type=float, default=2.0)
    args = p.parse_args()

    true_scene, cam = build(TRUE_ALBEDO)
    target = integrator.render_image(true_scene, cam, jax.random.key(9),
                                     spp=32)

    wrong_scene, _ = build((0.5, 0.5, 0.5))
    fitted, losses = diff.fit_scene(
        wrong_scene, cam, target, steps=args.steps, lr=args.lr,
        spp=args.spp, seed=3, param_filter={"tex_color0"}, log=print)

    got = np.asarray(fitted.textures.color0)[0]
    err = np.abs(got - np.asarray(TRUE_ALBEDO)).max()
    print(f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
          f"albedo {np.round(got, 3)} (true {TRUE_ALBEDO}, "
          f"max err {err:.3f})")


if __name__ == "__main__":
    main()
