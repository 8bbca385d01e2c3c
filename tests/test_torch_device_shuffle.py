"""The port's device shuffle against the reference package's.

The same numpy inputs go through ``repro.core.device_shuffle`` (JAX on
the CPU, a one-device mesh) and ``repro_torch.core.device_shuffle`` with
``device="cpu"``.  Counts, indices and the byte accounting are compared
exactly; the inputs are integer-valued.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import device_shuffle as jds
from repro.launch.mesh import make_mesh_compat
from repro.storage import DramTier as JDramTier
from repro_torch.core import device_shuffle as tds
from repro_torch.storage import DramTier

CPU = "cpu"


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_result(t, j):
    np.testing.assert_array_equal(_np(t.counts), _np(j.counts))
    assert int(t.dropped) == int(j.dropped)
    for name in ("shuffled_bytes", "buffer_bytes", "spilled", "spilled_bytes"):
        assert getattr(t, name) == getattr(j, name), name


@pytest.mark.parametrize("ndev,cap", [(4, 64), (2, 3), (3, 5)])
def test_pack_buckets_matches_reference(rng, ndev, cap):
    n = 64
    keys = rng.integers(-1, 100, n).astype(np.int32)
    dest = np.where(keys >= 0, keys % ndev, -1).astype(np.int32)
    vals = rng.integers(0, 9, n).astype(np.int32)
    jk, jv, jd = jds.pack_buckets(
        jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(dest), ndev, cap
    )
    tk, tv, td = tds.pack_buckets(
        torch.from_numpy(keys), torch.from_numpy(vals),
        torch.from_numpy(dest), ndev, cap,
    )
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(td) == int(jd)


@pytest.mark.parametrize("n,n_parts,cap", [
    (500, 7, None),  # sized from the kernel's counts: order only
    (200, 3, 10),  # capacity overflow
    (0, 3, None),  # empty input
])
def test_device_partition_matches_reference(rng, n, n_parts, cap):
    dest = rng.integers(-1, n_parts, n).astype(np.int32)
    jparts, jovf = jds.device_partition(dest, n_parts, capacity=cap)
    tparts, tovf = tds.device_partition(dest, n_parts, capacity=cap, device=CPU)
    assert len(tparts) == len(jparts) == n_parts
    for t, j in zip(tparts, jparts):
        assert t.dtype == np.int64
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(tovf, jovf)


def test_device_segment_reduce_matches_reference(rng):
    n, segs = 1000, 37
    ids = rng.integers(-1, segs, n).astype(np.int32)
    vals = rng.integers(-50, 50, n).astype(np.int32)
    got = tds.device_segment_reduce(ids, vals, segs, device=CPU)
    want = jds.device_segment_reduce(ids, vals, segs)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["uniform", "empty", "all_padding", "spill", "drop"])
def test_device_histogram_matches_reference(rng, case):
    vocab, n = 101, 512
    keys = rng.integers(-1, vocab, n).astype(np.int32)
    kw = {"capacity_factor": 4.0}
    if case == "empty":
        keys = keys[:0]
    elif case == "all_padding":
        keys = np.full(16, -1, np.int32)
    elif case in ("spill", "drop"):
        keys = (rng.zipf(1.4, n) % vocab).astype(np.int32)
        kw = {"capacity_factor": 0.05}
    vals = np.ones(len(keys), np.int32)
    jkw, tkw = dict(kw), dict(kw)
    if case == "spill":
        jkw["spill_tier"], tkw["spill_tier"] = JDramTier(), DramTier()
    mesh = make_mesh_compat((1,), ("data",))
    j = jds.device_histogram(
        jnp.asarray(keys), jnp.asarray(vals), mesh, "data", vocab=vocab, **jkw
    )
    t = tds.device_histogram(keys, vals, 1, vocab=vocab, device=CPU, **tkw)
    _assert_same_result(t, j)
    assert t.counts.dtype == torch.int32
    if case == "spill":
        np.testing.assert_array_equal(
            t.counts.numpy(), tds.host_histogram(keys, vals, vocab)
        )


def test_device_histogram_refuses_several_gpus():
    with pytest.raises(NotImplementedError):
        tds.device_histogram(np.zeros(4, np.int32), np.ones(4, np.int32), 2,
                             device=CPU)


@pytest.mark.parametrize("ndev", [1, 3, 8])
@pytest.mark.parametrize("spill", [False, True])
def test_storage_histogram_matches_reference(rng, ndev, spill):
    vocab, n = 50, 301  # prime length: the last shard is padded
    keys = (rng.zipf(1.4, n) % vocab).astype(np.int32)
    keys[::17] = -1
    vals = np.ones(n, np.int32)
    cf = 0.1 if spill else 8.0
    jtier, ttier = JDramTier(), DramTier()
    j = jds.storage_histogram(
        keys, vals, ndev, jtier, vocab=vocab, capacity_factor=cf, spill=spill
    )
    t = tds.storage_histogram(
        keys, vals, ndev, ttier, vocab=vocab, capacity_factor=cf, spill=spill,
        device=CPU,
    )
    _assert_same_result(t, j)
    # the same objects, byte for byte, went through both tiers
    assert sorted(ttier.keys()) == sorted(jtier.keys())
    for key in ttier.keys():
        assert ttier.get(key) == jtier.get(key)
    if spill:
        assert t.spilled > 0 and int(t.dropped) == 0
        np.testing.assert_array_equal(
            t.counts.numpy(), tds.host_histogram(keys, vals, vocab)
        )


def test_host_histogram_matches_reference(rng):
    keys = rng.integers(-1, 40, 900).astype(np.int32)
    vals = rng.integers(0, 5, 900).astype(np.int32)
    got = tds.host_histogram(keys, vals, 40)
    want = jds.host_histogram(keys, vals, 40)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
