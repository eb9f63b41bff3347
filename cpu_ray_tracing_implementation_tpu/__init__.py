"""Differentiable path tracer in JAX, for NVIDIA GPUs.

A brand-new JAX/XLA/Pallas re-design of the capabilities of the reference C++ CPU
renderer ``JTtNinjaCode/CPU-Ray-Tracing-Implementation`` (see SURVEY.md): four camera
models, six material families, MIS light sampling, sphere/quad/triangle/volume
primitives, BVH acceleration, motion blur, procedural noise and image textures,
glTF ingestion — restructured as a batched wavefront integrator over
structure-of-arrays scene tables, sharded over device meshes, and differentiable
w.r.t. material / emission / camera parameters.

Import shorthand::

    import cpu_ray_tracing_implementation_tpu as crt
"""

from cpu_ray_tracing_implementation_tpu.models.scene import Scene, SceneBuilder
from cpu_ray_tracing_implementation_tpu.models.camera import Camera
from cpu_ray_tracing_implementation_tpu.models.integrator import render_image, render_rays
from cpu_ray_tracing_implementation_tpu.models import catalog

__version__ = "0.1.0"

__all__ = [
    "Scene",
    "SceneBuilder",
    "Camera",
    "render_image",
    "render_rays",
    "catalog",
]
