"""The slice as a whole: the same jobs through both packages' clients.

WordCount, grep, aggregation and TeraSort run through
``repro.api.MarvelClient`` and ``repro_torch.api.MarvelClient`` on the
same seeded corpus, in host mode and in device mode on the CPU
(``device_interpret=True``: interpret mode in the reference, the
kernels' plain versions in the port), capacity spill included.  Output
bytes and the report's device fields must be identical.  Last, a job the
reference crashes on a PMEM journal is resumed by the port.
"""

import shutil

import numpy as np
import pytest

import repro.api as japi
import repro.core.mapreduce as jmr
from repro.core.scheduler import TaskFailedError
import repro_torch.api as tapi
import repro_torch.core.mapreduce as tmr

PKGS = {"jax": (japi, jmr), "torch": (tapi, tmr)}
DEVICE_FIELDS = (
    "device_mode", "device_pairs", "device_groups", "device_spilled_pairs",
    "device_fallback_tasks",
)


def _text(seed=5, lines=200, words_per_line=12):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}".encode() for i in range(300)]
    ids = (rng.zipf(1.3, (lines, words_per_line)) - 1) % len(vocab)
    return b"\n".join(b" ".join(vocab[i] for i in row) for row in ids)


def _csv(seed=6, rows=200):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 9, rows)
    vals = rng.integers(0, 64, rows) / 8
    return b"\n".join(f"k{k},{v}".encode() for k, v in zip(keys, vals))


JOBS = {
    "wordcount": (lambda mr: mr.wordcount_job(4), _text),
    "grep": (lambda mr: mr.grep_job(rb"^w1"), _text),
    "aggregation": (lambda mr: mr.aggregation_job(), _csv),
}


def _read_parts(store, path, n=4):
    return [
        store.read(f"{path}/part_{p:04d}")
        if store.exists(f"{path}/part_{p:04d}") else None
        for p in range(n)
    ]


def _mapreduce(pkg, job, device, capacity_factor=1.3):
    api, mr = PKGS[pkg]
    make_job, make_data = JOBS[job]
    cfg = api.ClusterConfig(
        block_size=1 << 10, device_interpret=True,
        device_capacity_factor=capacity_factor,
    )
    with api.MarvelClient(cfg) as c:
        c.store.write("/in", make_data(), record_delim=b"\n")
        h = c.mapreduce(make_job(mr), "/in", "/out", device=device)
        extra = h.report.extra
        return (
            _read_parts(c.store, "/out"),
            {k: extra[k] for k in DEVICE_FIELDS},
            (h.report.tasks, h.report.resumed_tasks),
        )


@pytest.mark.parametrize("job,device,capacity_factor", [
    ("wordcount", False, 1.3),
    ("wordcount", True, 1.3),
    ("wordcount", True, 0.05),  # nearly every pair spills
    ("grep", False, 1.3),
    ("grep", True, 1.3),
    ("aggregation", False, 1.3),
    ("aggregation", True, 1.3),  # float sums: host reducer fallback
])
def test_mapreduce_matches_reference(job, device, capacity_factor):
    want = _mapreduce("jax", job, device, capacity_factor)
    got = _mapreduce("torch", job, device, capacity_factor)
    assert got == want
    outs, fields, _ = got
    assert any(outs)
    if device:
        assert fields["device_pairs"] > 0
        host_outs, _, _ = _mapreduce("torch", job, False)
        assert outs == host_outs
    if capacity_factor < 1:
        assert fields["device_spilled_pairs"] > 0


def _terasort_parts(seed=11):
    rng = np.random.default_rng(seed)
    return [
        b"\n".join(f"r{v:06d}".encode() for v in rng.integers(0, 99999, 200))
        for _ in range(3)
    ]


@pytest.mark.parametrize("device", [False, True])
def test_terasort_matches_reference(device):
    results = {}
    for pkg, (api, _) in PKGS.items():
        with api.MarvelClient(api.ClusterConfig(device_interpret=True)) as c:
            h = c.terasort("ts", _terasort_parts(), n_ranges=4, device=device)
            results[pkg] = (h.result, h.report.extra.get("device_tasks"))
    assert results["torch"] == results["jax"]
    records, device_tasks = results["torch"]
    assert records == sorted(records) and len(records) == 600
    if device:
        assert device_tasks == 3  # one per scatter


def _journaled(api, root):
    return api.ClusterConfig(
        name="resume", block_size=1 << 10,
        tiers=(api.TierSpec("pmem", path=str(root / "state")),),
        journal="pmem", journal_path=str(root / "journal"),
    )


def _wordcount_on(api, mr, root, **kw):
    with api.MarvelClient(_journaled(api, root)) as c:
        c.store.write("/in", _text(), record_delim=b"\n")
        h = c.mapreduce(mr.wordcount_job(4), "/in", "/out", **kw)
        return _read_parts(c.store, "/out"), h.report


def test_port_resumes_a_job_the_reference_crashed(tmp_path):
    crashed = tmp_path / "crashed"
    with pytest.raises(TaskFailedError):
        _wordcount_on(japi, jmr, crashed, fail_map_attempts={"map_00003": 99})
    # Resume one copy of the durable state with each package.
    shutil.copytree(crashed, tmp_path / "jax")
    shutil.copytree(crashed, tmp_path / "torch")
    want, jrep = _wordcount_on(japi, jmr, tmp_path / "jax")
    got, trep = _wordcount_on(tapi, tmr, tmp_path / "torch")
    assert got == want and any(got)
    assert 0 < trep.resumed_tasks < trep.tasks
    assert (trep.tasks, trep.resumed_tasks) == (jrep.tasks, jrep.resumed_tasks)
    golden, _ = _wordcount_on(tapi, tmr, tmp_path / "golden")
    assert got == golden
