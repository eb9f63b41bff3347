"""Multi-host (pod-slice) setup and host-local render orchestration.

The reference is single-process (SURVEY.md §2.4); here a pod slice is the
scale-out story: `jax.distributed.initialize` brings every host's chips into
one global mesh, the scene replicates, pixels shard globally, and the final
image assembles through jit output sharding (all_gather within a
slice, DCN across hosts — XLA inserts the collectives; nothing hand-rolled).

Single-host multi-chip needs none of this — `parallel.mesh` alone suffices.
"""

from __future__ import annotations

import jax
import numpy as np

from cpu_ray_tracing_implementation_tpu.parallel import mesh as pm


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the multi-process job. Where no cluster environment announces
    the job (a plain GPU host), pass all three arguments: the coordinator
    as ``localhost:<port>`` (any free port) on one host."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def global_mesh() -> "jax.sharding.Mesh":
    """1-D mesh over every chip in the job (all hosts)."""
    return pm.make_mesh(jax.devices())


def render_image_global(scene, camera, key, spp: int | None = None):
    """Render with pixels sharded over the global (multi-host) mesh.

    Returns the full image as a host-local numpy array on every process.
    The render output is sharded across all hosts' chips (non-addressable
    from any single process), so it is gathered with process_allgather.
    """
    mesh = global_mesh()
    img = pm.render_image_sharded(scene, camera, key, mesh, spp=spp)
    if jax.process_count() == 1:
        return np.asarray(jax.device_get(img))
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(img, tiled=True))
