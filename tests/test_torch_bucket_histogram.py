"""The port's bucket histogram against the reference package's.

The same numpy keys go through ``repro.kernels.ops`` (the Pallas kernel,
in interpret mode on the CPU) and ``repro_torch.kernels.ops`` (on a CPU
tensor, the plain version).  Counts are integers and compared exactly.
The CUDA kernel itself runs only on the card, where ``chip_smoke.py``
holds it against the plain version; here its plan (pure Python) and the
wrapper's per-device and per-signature caches are checked.
"""

import ctypes


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
    (4099, 16, 1024),  # the register route's widest
    (999, 17, 256),  # the shared-memory route's narrowest
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


# -- the CUDA wrapper's plan -------------------------------------------------

SMS, OPTIN = 132, 232_448  # an H100's SM count and shared-memory opt-in
ROUTE_EDGES = [
    (1, "regs"), (4, "regs"), (16, "regs"), (17, "smem"), (58_112, "smem"),
    (58_113, "global"), (131_072, "global"), (929_792, "global"),
    (929_793, "global"),
]


@pytest.mark.parametrize("n", [0, 131_032, bh.CROSSOVER, bh.CROSSOVER + 1,
                               1 << 28])
@pytest.mark.parametrize("n_buckets,route", ROUTE_EDGES)
def test_plan_route_edges_fit_the_card(n_buckets, route, n):
    p = bh._plan(n, n_buckets, SMS, OPTIN)
    assert p.route == route
    assert 1 <= p.cluster <= bh.MAX_CLUSTER
    assert 0 <= p.smem <= OPTIN
    assert p.grid >= 1 and p.grid % p.cluster == 0
    # one cluster up to the crossover (one launch), a grid above (a memset
    # and a launch); the global route always zeroes and adds
    assert p.single == (n <= bh.CROSSOVER and route != "global")
    assert p.grid == p.cluster if p.single else p.grid <= SMS
    if route == "regs":
        assert n_buckets <= p.width in bh.REGS_WIDTHS
        assert p.smem == 4 * p.width
    elif route == "smem":
        assert 1 <= p.copies <= bh.THREADS // 32
        assert p.smem == 4 * p.copies * n_buckets
        assert p.copies == bh.THREADS // 32 or 4 * (p.copies + 1) * n_buckets > OPTIN
    else:  # past one block's shared memory
        assert n_buckets > OPTIN // 4
        assert p.cluster == 1 and p.smem == 0 and p.grid == SMS


@pytest.mark.parametrize("n,blocks", [
    (0, 1), (1, 1), (bh.KEYS_PER_BLOCK, 1), (bh.KEYS_PER_BLOCK + 1, 2),
    (131_032, 16), (bh.CROSSOVER, 16),
])
def test_one_cluster_is_sized_to_n(n, blocks):
    p = bh._plan(n, 4, SMS, OPTIN)
    assert p.single and p.cluster == p.grid == blocks
    assert bh._size_class(n) == blocks


def test_plan_matches_the_kernels_struct():
    assert ctypes.sizeof(bh._Plan) == 28  # static_assert in the source
    for n, n_buckets in ((1 << 28, 131_072), (131_032, 4), (1 << 28, 128)):
        p = bh._plan(n, n_buckets, SMS, OPTIN)
        st = bh._struct(p)
        assert (st.route, st.width, st.single, st.grid, st.cluster, st.smem,
                st.copies) == (bh.ROUTES.index(p.route), p.width, int(p.single),
                               p.grid, p.cluster, p.smem, p.copies)


@pytest.fixture
def fresh_caches(monkeypatch):
    """Empty plan and device caches, and a counting stand-in for the
    once-per-device set-up (an H100's numbers)."""
    calls = {"configure": 0, "plan": 0}
    real_plan = bh._plan

    def configure(index):
        calls["configure"] += 1
        return SMS, OPTIN

    def plan(*a):
        calls["plan"] += 1
        return real_plan(*a)

    for name in ("_calls", "_devices"):
        monkeypatch.setattr(bh, name, {})
    monkeypatch.setattr(bh, "_configure", configure)
    monkeypatch.setattr(bh, "_plan", plan)
    return calls


def test_a_signature_is_planned_once_and_a_device_set_up_once(fresh_caches):
    first = bh._call_for(0, 131_032, 4)
    assert bh._call_for(0, 131_032, 4) is first
    assert bh._call_for(0, 131_000, 4) is first  # same size class
    assert fresh_caches == {"configure": 1, "plan": 1}
    assert first.address == ctypes.addressof(first.struct)
    other = bh._call_for(0, 1 << 28, 4)  # a grid of clusters over the card
    assert bh._call_for(0, (1 << 28) - 5, 4) is other
    assert not other.plan.single
    assert other.plan.grid == SMS // bh.GRID_CLUSTER * bh.GRID_CLUSTER
    assert fresh_caches == {"configure": 1, "plan": 2}
    bh._call_for(1, 131_032, 4)  # another card: its own set-up
    assert fresh_caches["configure"] == 2 and set(bh._devices) == {0, 1}
