"""Every float contraction in a render pins Precision.HIGHEST.

On a GPU an f32 dot_general with the default precision may run in TF32,
which keeps about three decimal digits: enough to crack walls open (rays
pass between quads) and to bend volume frames. Checked on the traced
program, so it holds for whatever backend compiles it.
"""

import jax
import jax.numpy as jnp
import pytest
from jax import lax

from cpu_ray_tracing_implementation_tpu.models import catalog, diff, integrator


def _dot_precisions(jaxpr, out):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            if jnp.issubdtype(eqn.invars[0].aval.dtype, jnp.floating):
                out.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            _dot_precisions(sub, out)
    return out


def _precisions(fn, *args):
    return _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr, [])


HIGHEST = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)


@pytest.mark.parametrize("name", ["cornell_box_with_volume", "sponza"])
@pytest.mark.parametrize("mode", ["forward", "backward"])
def test_every_dot_general_is_highest(name, mode):
    scene, cam = catalog.SCENES[name](width=8, spp=1, max_depth=2)
    key = jax.random.key(0)
    if mode == "forward":
        precs = _precisions(
            lambda s: integrator.render_image(s, cam, key), scene)
    else:
        target = jnp.zeros((cam.height, cam.width, 3))
        precs = _precisions(
            lambda s: diff.loss_and_grads(s, cam, key, target, spp=1), scene)
    assert precs, "no contraction traced"
    bad = [p for p in precs if p != HIGHEST]
    assert not bad, f"{len(bad)}/{len(precs)} dot_generals not HIGHEST: " \
                    f"{sorted(set(map(str, bad)))}"
