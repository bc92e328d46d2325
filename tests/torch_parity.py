"""Shared JAX-side reference for the port's trainer tests (not a test
module).

``jax_sequential_curve`` is the JAX package's sequential training step —
``TransparentTrainer._local_step`` on one replica: ``value_and_grad`` of
the bundle loss, fp32 gradients, ``clip_by_global_norm`` (or
``global_norm``), the optimizer update — jitted without a mesh.  The JAX
trainer itself lowers through ``shard_map``, which fails on some installs
of jax 0.9.0; this curve is the same arithmetic on one device.
"""
import jax
import jax.numpy as jnp

from repro.models import registry as jax_registry
from repro.optim import optimizers as jax_opt


def jax_sequential_curve(cfg, params, batches, opt_cfg, *, loss_fn=None,
                         opt_state=None):
    """Losses and grad norms of ``len(batches)`` sequential steps from
    ``params`` (the JAX init tree) with ``opt_cfg``.  ``loss_fn(params,
    batch)`` replaces the bundle's loss (the cnn family has no bundle;
    ``cfg`` is then unused); ``opt_state`` starts the optimizer from a
    given state (a resumed run) instead of ``opt.init(params)``."""
    if loss_fn is None:
        loss_fn = jax_registry.build(cfg).loss_fn
    opt = jax_opt.make_optimizer(opt_cfg)

    @jax.jit
    def step(params, state, batch):
        loss, g = jax.value_and_grad(loss_fn)(params, batch)
        g = jax.tree.map(lambda x: x.astype(jnp.float32), g)
        if opt_cfg.grad_clip:
            g, gn = jax_opt.clip_by_global_norm(g, opt_cfg.grad_clip)
        else:
            gn = jax_opt.global_norm(g)
        params, state = opt.update(g, state, params)
        return params, state, loss, gn

    state = opt.init(params) if opt_state is None else opt_state
    losses, norms = [], []
    for b in batches:
        params, state, loss, gn = step(params, state,
                                       jax.tree.map(jnp.asarray, b))
        losses.append(float(loss))
        norms.append(float(gn))
    return losses, norms
