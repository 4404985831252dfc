"""The port's batch norms in training mode over 4 gloo ranks vs the JAX
package's ``MaskedBatchNorm`` on the concatenated rows, on the CPU.

Four ranks hold unequal numbers of rows, unequal numbers of them valid,
and one rank holds no valid row. Each rank runs ``MaskedBatchNorm`` on its
rows and backpropagates ``sum(y * cot)`` for a seeded cotangent; the JAX
norm runs on every rank's rows at once (``train=True``, ``jax.grad`` of
the same sum). Held, to 1e-5 relative (of each tensor's largest value) in
fp32: each rank's output and input gradient against its rows of JAX's,
its running statistics (the same on every rank) against JAX's, and the
ranks' affine gradients summed (what the train step's reduction gives)
against JAX's. The unmasked 2-D norm (``NaiveSyncBatchNorm2d``, NCHW maps
split over the ranks by sample) against the JAX norm without a mask on
the NHWC maps.
"""
import numpy as np
import jax
import jax.numpy as jnp

from msmdfusion_tpu.models.layers import MaskedBatchNorm as JaxNorm
from tests.torch_ranks import run_ranks, sync_norm_rank

TOL = 1e-5
WORLD = 4
C = 6


def jax_norm(x, mask, cot, params):
    """(y, d/dx, d/dscale, d/dbias, new running mean, new running var)."""
    norm = JaxNorm()
    stats = {'mean': jnp.asarray(params['running_mean']),
             'var': jnp.asarray(params['running_var'])}

    def loss(x, scale, bias):
        y, new = norm.apply({'params': {'scale': scale, 'bias': bias},
                             'batch_stats': stats}, x, mask=mask,
                            train=True, mutable=['batch_stats'])
        return (y * cot).sum(), (y, new['batch_stats'])

    (_, (y, new)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(x), jnp.asarray(params['weight']),
            jnp.asarray(params['bias']))
    return (np.asarray(y), *map(np.asarray, grads),
            np.asarray(new['mean']), np.asarray(new['var']))


def close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def test_global_moments_match_jax_over_four_ranks():
    rng = np.random.RandomState(0)
    counts = [37, 5, 20, 9]
    rows = [(rng.randn(n, C) * 3 + rng.randn(C)).astype(np.float32)
            for n in counts]
    masks = [rng.rand(n) < 0.6 for n in counts]
    masks[1][:] = False                        # rank 1: no valid row
    cots = [rng.randn(n, C).astype(np.float32) for n in counts]
    params = dict(weight=rng.uniform(0.5, 1.5, C).astype(np.float32),
                  bias=rng.randn(C).astype(np.float32),
                  running_mean=rng.randn(C).astype(np.float32),
                  running_var=rng.uniform(0.5, 1.5, C).astype(np.float32))
    grid = rng.randn(WORLD, 2, C, 3, 5).astype(np.float32) * 2 + 1
    grid_cot = rng.randn(WORLD, 2, C, 3, 5).astype(np.float32)
    out = run_ranks(sync_norm_rank, WORLD, rows, masks, cots, params,
                    grid, grid_cot)

    cases = (
        ('masked', np.concatenate(rows), np.concatenate(masks),
         np.concatenate(cots), lambda a: np.split(a, np.cumsum(counts)[:-1])),
        ('2d', grid.reshape(-1, C, 3, 5).transpose(0, 2, 3, 1), None,
         grid_cot.reshape(-1, C, 3, 5).transpose(0, 2, 3, 1),
         lambda a: np.split(a.transpose(0, 3, 1, 2), WORLD)))
    for name, x, mask, cot, per_rank in cases:
        y, dx, dscale, dbias, mean, var = jax_norm(x, mask, cot, params)
        for rank, (want_y, want_dx) in enumerate(zip(per_rank(y),
                                                     per_rank(dx))):
            got = out[rank][name]
            close(got['y'], want_y, f'{name} y, rank {rank}')
            close(got['x_grad'], want_dx, f'{name} d/dx, rank {rank}')
            close(got['running_mean'], mean, f'{name} mean, rank {rank}')
            close(got['running_var'], var, f'{name} var, rank {rank}')
            np.testing.assert_array_equal(got['running_var'],
                                          out[0][name]['running_var'])
        close(sum(o[name]['weight_grad'] for o in out), dscale,
              f'{name} d/dweight')
        close(sum(o[name]['bias_grad'] for o in out), dbias,
              f'{name} d/dbias')
    # the rank without a valid row: zero output rows, still a share of
    # the affine gradients (zero) and the global statistics
    assert not out[1]['masked']['y'].any()
    assert not out[1]['masked']['weight_grad'].any()
