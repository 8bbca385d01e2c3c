"""The port's bucket histogram against the reference package's.

The same numpy keys go through ``repro.kernels.ops`` (the Pallas kernel,
in interpret mode on the CPU) and ``repro_torch.kernels.ops`` (on a CPU
tensor, the plain version).  Counts are integers and compared exactly.
The CUDA kernel itself runs only on the card, where ``chip_smoke.py``
holds it against the plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.kernels import bucket_histogram as bh
from repro_torch.kernels import ops, ref


def _jax_hist(keys, buckets, **kw):
    return np.asarray(jops.shuffle_histogram(jnp.asarray(keys), buckets, **kw))


def _hist(keys, buckets, **kw):
    return ops.shuffle_histogram(torch.from_numpy(keys), buckets, **kw)


@pytest.mark.parametrize("n,buckets,block", [
    (1000, 16, 256),
    (5000, 128, 2048),
    (100, 7, 64),  # unaligned
])
def test_sweep_matches_reference(rng, n, buckets, block):
    keys = rng.integers(-1, buckets, n).astype(np.int32)
    got = _hist(keys, buckets)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_hist(keys, buckets, block=block))
    np.testing.assert_array_equal(
        ref.bucket_histogram_ref(torch.from_numpy(keys), buckets).numpy(),
        got.numpy(),
    )


@pytest.mark.parametrize("case", ["empty", "below_block", "all_padding", "over_range"])
def test_edge_cases_match_reference(rng, case):
    keys = {
        "empty": np.zeros((0,), np.int32),
        "below_block": rng.integers(-1, 8, 5).astype(np.int32),
        "all_padding": np.full((64,), -1, np.int32),
        # keys >= n_buckets are dropped, never written out of bounds
        "over_range": rng.integers(-3, 20, 777).astype(np.int32),
    }[case]
    got = _hist(keys, 8)
    assert got.shape == (8,)
    np.testing.assert_array_equal(got.numpy(), _jax_hist(keys, 8))


def test_out_dtype_float32(rng):
    keys = rng.integers(0, 16, 1000).astype(np.int32)
    got = _hist(keys, 16, out_dtype=torch.float32)
    want = _jax_hist(keys, 16, out_dtype=jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_partition_counts_matches_reference(rng):
    dest = rng.integers(-1, 7, 999).astype(np.int32)
    got = ops.partition_counts(torch.from_numpy(dest), 7).numpy()
    want = np.asarray(jops.partition_counts(jnp.asarray(dest), 7))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        ops.partition_counts(torch.zeros(4, dtype=torch.int32), 0)


def test_int32_exact_past_2_24():
    # 2^24 + 65 keys in one bucket: an f32 accumulator cannot hold it.
    n = (1 << 24) + 65
    keys = np.zeros(n, np.int32)
    keys[-64:] = 2
    got = _hist(keys, 4).numpy()
    np.testing.assert_array_equal(got, np.bincount(keys, minlength=4))
    assert int(got[0]) > 1 << 24


def test_cpu_tensor_runs_plain_version_without_launch(rng):
    before = bh.launches
    keys = rng.integers(-1, 32, 500).astype(np.int32)
    _hist(keys, 32)
    ops.partition_counts(torch.from_numpy(keys), 4)
    assert bh.launches == before


@pytest.mark.parametrize("bad", ["dtype", "rank", "device", "n_buckets"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    keys = torch.zeros(16, dtype=torch.int32)
    n_buckets = 4
    if bad == "dtype":
        keys = keys.long()
    elif bad == "rank":
        keys = keys.reshape(4, 4)
    elif bad == "device":
        keys = keys.to("meta")  # neither the CPU nor the card
    else:
        n_buckets = 0
    with pytest.raises((TypeError, ValueError)):
        bh.bucket_histogram(keys, n_buckets)
