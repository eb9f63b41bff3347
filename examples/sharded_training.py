"""Data-parallel differentiable rendering over a device mesh.

One training step of the sharded inverse-rendering objective: pixels are
sharded over every visible device (`parallel/mesh.py` shard_map), each
shard renders + backprops its pixel block, and parameter gradients are
psum-all-reduced — the standard DP recipe, with radiance streams that are
bitwise identical at any device count (per-pixel counter-based RNG).

Run on any host with 8 virtual CPU devices (no multi-GPU host required):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/sharded_training.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

# The demo is about the mesh, so default to 8 virtual CPU devices; set
# CRT_EXAMPLE_DEVICES=native to use whatever backend JAX picks (e.g. the
# GPUs of one host).
if os.environ.get("CRT_EXAMPLE_DEVICES") != "native":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

from cpu_ray_tracing_implementation_tpu.models import catalog  # noqa: E402
from cpu_ray_tracing_implementation_tpu.parallel import mesh as pm  # noqa: E402


def main():
    devs = jax.devices()
    print(f"{len(devs)} {devs[0].platform} devices")
    mesh = pm.make_mesh(devs)

    scene, cam = catalog.cornell_box(width=64, spp=4, max_depth=4)
    target = jnp.zeros((cam.height, cam.width, 3), jnp.float32)

    # fixed key: descend on one sample realization so the printed loss
    # falls monotonically (a real fit re-draws per step, diff.fit_scene)
    key = jax.random.key(0)
    for step in range(3):
        loss, (gs, _gc) = pm.render_loss_and_grad_sharded(
            scene, cam, key, target, mesh, spp=4)
        g = gs["tex_color0"]
        scene = scene.replace(textures=scene.textures.replace(
            color0=jnp.clip(scene.textures.color0 - 0.5 * g, 0.0, None)))
        print(f"step {step}: loss {float(loss):.5f} "
              f"|grad| {float(jnp.linalg.norm(g)):.5f}")


if __name__ == "__main__":
    main()
