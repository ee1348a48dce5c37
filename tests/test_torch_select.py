"""PyTorch port, fused assignment kernel (spark_rapids_ml_torch/ops/select.py):
its plain version, which the CPU wrapper runs, against the JAX package's Pallas
kernel in interpret mode (ops/pallas_select.py::fused_assign) on the same numpy
inputs. The data have a clear margin, so the labels must be identical. The
n_split 2 form (parity_precision="high") against `_fused_assign(..., 2,
interpret=True)`, which splits explicitly, on blobs and on flip data, where the
split and f32 choose different centers for every row."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops.pallas_select import _fused_assign, fused_assign
from spark_rapids_ml_torch.ops import select


def _blobs(n, d, k, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 10, (k, d)).astype(np.float32)
    X = centers[rng.integers(0, k, n)] + rng.normal(0, 0.5, (n, d)).astype(np.float32)
    return X.astype(np.float32), centers


@pytest.mark.parametrize("n, d, k", [(1000, 3, 1), (777, 16, 20), (513, 130, 7)])
def test_assign_matches_fused_assign_interpret(n, d, k):
    X, C = _blobs(n, d, k, seed=d + k)
    got = select.assign(torch.from_numpy(X), torch.from_numpy(C))
    want = np.asarray(fused_assign(jnp.asarray(X), jnp.asarray(C), interpret=True))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_duplicate_centers_first_index_wins():
    X, C = _blobs(300, 8, 3, seed=5)
    C = np.concatenate([C, C[:2]])  # centers 3 and 4 duplicate 0 and 1
    got = select.assign(torch.from_numpy(X), torch.from_numpy(C)).numpy()
    want = np.asarray(fused_assign(jnp.asarray(X), jnp.asarray(C), interpret=True))
    np.testing.assert_array_equal(got, want)
    assert got.max() <= 2  # the duplicates never win


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    X, C = _blobs(64, 4, 3)
    before = select.assign.launches
    got = select.assign(torch.from_numpy(X), torch.from_numpy(C))
    assert torch.equal(got, select.assign_plain(torch.from_numpy(X), torch.from_numpy(C)))
    assert select.assign.launches == before


def test_wrapper_rejects_mismatched_widths():
    with pytest.raises(ValueError):
        select.assign(torch.zeros((5, 3)), torch.zeros((2, 4)))


def _jax_assign_high(X, C, block=128):
    return np.asarray(_fused_assign(jnp.asarray(X), jnp.asarray(C), block, 2, True))


@pytest.mark.parametrize("n, d, k", [(1000, 3, 1), (777, 16, 20), (513, 130, 7)])
def test_high_assign_matches_the_jax_split_kernel(n, d, k):
    X, C = _blobs(n, d, k, seed=d + k)
    got = select.assign(torch.from_numpy(X), torch.from_numpy(C), 2)
    np.testing.assert_array_equal(got.numpy(), _jax_assign_high(X, C))


def test_high_assign_moves_every_flip_row_to_center_0():
    """Flip data (tests/test_torch_lloyd.py::_flip_data): the split puts every
    row at the origin, center 0; f32 each in its own center."""
    from tests.test_torch_lloyd import _flip_data

    X, C = _flip_data(901, 30, 5)
    got = select.assign(torch.from_numpy(X), torch.from_numpy(C), 2).numpy()
    np.testing.assert_array_equal(got, _jax_assign_high(X, C))
    assert (got == 0).all()
    assert (select.assign(torch.from_numpy(X), torch.from_numpy(C)).numpy() != 0).all()


def test_wrapper_rejects_a_split_it_has_no_form_for():
    with pytest.raises(ValueError, match="n_split"):
        select.assign(torch.zeros((5, 3)), torch.zeros((2, 3)), 1)
