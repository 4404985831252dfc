"""The GMA encoder's ablation switches and the sparse blocks' two
result-changing switches, port vs the JAX package on the CPU.

- ``MSMD_GMA_NN=exact``: ``exact_nn_3d`` rows equal JAX's on the four
  stages of ``test_torch_gma.py``;
- ``MSMD_GMA_DUMMY=random:<seed>``: ``utils/prng.uniform`` bit-equal to
  ``jax.random.uniform(PRNGKey(seed * 8 + i), (c3,))`` for several seeds
  and every stage width of the full-width flagship;
- the whole encoder under each of ``MSMD_GMA_NN=exact``,
  ``MSMD_GMA_DUMMY=random:7``, ``MSMD_FUSE_BN=0`` (its grouped, aggregation
  and downscale blocks run the conv with no epilogue, then the norm and
  the ReLU) and ``MSMD_SPARSE_BACKEND=xla`` (the plain versions: on the
  CPU, the default path), set for both packages, held stage by stage to
  the JAX encoder under the same switch with ``test_torch_gma.py``'s
  tolerance (1e-4 of the largest value).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from msmdfusion_tpu.models.middle_encoders import gma_encoder as jgma

from msmdfusion_torch.models.middle_encoders import gma_encoder as tgma
from msmdfusion_torch.utils.prng import uniform
from tests.test_torch_gma import (assert_stages_close, gma_outputs,
                                  stages)  # noqa: F401  (a fixture)
from tests.torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize('thresh', [13.3, 1.6])
def test_exact_nn_3d_matches_jax(stages, thresh):  # noqa: F811
    found = 0
    for (j3, t3), (j2, t2) in stages:
        only_2d = tgma.modality_split(t3, t2)['only_2d']
        want = jax.jit(jgma.exact_nn_3d, static_argnums=(4,))(
            j2.coords, jnp.asarray(only_2d.numpy()), j3.coords, j3.valid,
            thresh)
        got = tgma.exact_nn_3d(t2.coords, only_2d, t3.coords, t3.valid,
                               thresh)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        found += int((got >= 0).sum())
    assert found > 0


@pytest.mark.parametrize('seed', [0, 7, 1234])
def test_random_dummy_is_jax_uniform(seed):
    for i, c3 in enumerate((16, 32, 64, 128)):
        want = np.asarray(jax.random.uniform(
            jax.random.PRNGKey(seed * 8 + i), (c3,)))
        got = uniform(seed * 8 + i, c3)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))


SWITCHES = [('MSMD_GMA_NN', 'exact'), ('MSMD_GMA_DUMMY', 'random:7'),
            ('MSMD_FUSE_BN', '0'), ('MSMD_SPARSE_BACKEND', 'xla')]


@pytest.mark.parametrize('name,value', SWITCHES,
                         ids=[f'{n}={v}' for n, v in SWITCHES])
def test_gma_encoder_under_switch_matches_jax(stages, name,  # noqa: F811
                                              value, monkeypatch):
    monkeypatch.setenv(name, value)
    got, want, _ = gma_outputs(stages, monkeypatch)
    assert_stages_close(got, want)
