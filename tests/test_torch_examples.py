"""The port's examples (``repro_torch/examples/``) against the reference's
(``examples/``), run on the CPU in the test process.

Each reference example runs once per module through a fixture, loaded by
file path; its printed lines are held equal to its twin's once every
wall-clock figure is masked (``ms``, ``s`` and ``tok/s`` figures and
quickstart's "% reduction").  Every count and byte figure stays: shuffled
MB, dropped pairs, intermediate MB, the quota message, resumed/tasks,
iterations, the warm-read share, "outputs identical", "globally sorted"
and the "+N ms of modeled object-store I/O".  One count is masked too:
the bytes the S3 tier had moved when its quota tripped.  The map tasks
run on the client's 4 invokers and their commits may be batched into one
write, so in either package the quota trips at 16944 B in most runs and
at 19768 B (two tasks' blocks in one batch) in others (about 1 run in 5
on an 8-core host).  With one invoker the tasks commit one after another,
and there the whole quota message is held equal to the reference's.

Where an example writes outside its call, the test points it at
``tmp_path`` without editing it: the reference's quickstart journals to
the fixed ``/tmp/marvel_quickstart`` (a journal left there by an earlier
run changes what the crash resumes), so its module-level ``ClusterConfig``
is replaced by a wrapper that sets ``journal_path``; its serve_lm makes
temporary directories and leaves them, so its ``tempfile`` is replaced by
one that makes them under ``tmp_path``.  The twins take their paths as
arguments.

serve_lm: the reference's weights (cast to f32 by wrapping its
``init_params``, as ``tests/test_torch_serving.py`` holds greedy tokens
in f32) and prompts are recorded through its pool and carried to the
twin's ``run`` with ``from_jax_params``.  Every conversation's tokens,
the pager's counts, the sessions re-adopted after the restart and the
token after it are equal.
"""

import contextlib
import importlib.util
import io
import re
import tempfile
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.storage as jstorage
import repro_torch.api as tapi
import repro_torch.storage as tstorage
from repro.core import device_histogram as jdevice_histogram
from repro.jax_compat import make_mesh as jmake_mesh
from repro_torch.configs import get_config
from repro_torch.core import device_histogram
from repro_torch.examples import iterative_dataflow, mapreduce_device, quickstart, serve_lm
from repro_torch.kernels import ops
from repro_torch.models import from_jax_params, reduced_for_smoke

ROOT = Path(__file__).resolve().parents[1]

#: a wall-clock figure: a number right before "ms", "s" or "tok/s" (not
#: the "+N ms" of modeled I/O), with the padding before it
_WALL = re.compile(r" *(?<![+\d.])\d+(?:\.\d+)?(?= ?(?:ms|s|tok/s)\b)")
_REDUCTION = re.compile(r"\d+(?:\.\d+)?(?=% reduction)")
_MOVED = re.compile(r"\(\d+ B moved\)")


def masked(text: str) -> list:
    """``text``'s lines with every wall-clock figure replaced by ``#``."""
    def mask(m):
        return (" #" if m.group(0).startswith(" ") else "#")

    return [_MOVED.sub("(# B moved)", _REDUCTION.sub("#", _WALL.sub(mask, line)))
            for line in text.splitlines()]


def test_masking_keeps_counts_and_modeled_time():
    line = ("modeled S3:     5439.5 ms  (+3223 ms of modeled object-store I/O), "
            "145 tokens in 14.97s (9.7 tok/s), 13 tasks over 3 stages, "
            "pinned 3.8 ms/iter, 0.02 MB, -> 91.9% reduction, (16944 B moved)")
    assert masked(line) == [
        "modeled S3: # ms  (+3223 ms of modeled object-store I/O), 145 tokens in #s "
        "(# tok/s), 13 tasks over 3 stages, pinned # ms/iter, 0.02 MB, -> #% reduction, "
        "(# B moved)"]


def _load(name: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(f"reference_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args, **kwargs)
    return buf.getvalue(), ret


# -- mapreduce_device ------------------------------------------------------------

@pytest.fixture(scope="module")
def mapreduce_runs():
    ref, _ = _printed(_load("mapreduce_device").main)
    port, out = _printed(mapreduce_device.main, ["--device", "cpu"])
    return ref, port, out


def test_mapreduce_device_prints_the_reference_figures(mapreduce_runs):
    ref, port, _ = mapreduce_runs
    assert "0.5 MB, 0 dropped" in ref and "+3223 ms of modeled" in ref
    assert masked(port) == masked(ref)


def test_mapreduce_device_counts_every_token(mapreduce_runs):
    _, _, out = mapreduce_runs
    assert out["counts"].sum() == 1 << 16 and out["dropped"] == 0


_KEYS = np.random.default_rng(5).integers(-1, 300, 1000).astype(np.int32)


@pytest.mark.parametrize("values,capacity_factor,unit,kernel", [
    (np.ones(1000, np.float32), 2.0, True, torch.float32),  # the example's call
    (np.ones(1000, np.int32), 1.3, True, torch.int32),
    (np.ones(1000, np.int32), 0.5, True, torch.int32),  # capacity drops
    (np.ones(1000, np.int32), 1.3, False, None),  # not declared: segment sum
    (np.full(1000, 2.0, np.float32), 1.3, False, None),  # weights: segment sum
], ids=["f32_ones", "int32_ones", "int32_drops", "undeclared", "weighted"])
def test_device_histogram_counts_unit_weights_through_the_kernel(
        monkeypatch, values, capacity_factor, unit, kernel):
    """One owner and ``unit_weights=True``: the reduce is
    ``bucket_histogram``'s count, and every field equals the reference's on
    one device; without it the values are segment-summed."""
    calls = []
    real = ops.shuffle_histogram

    def spy(keys, n_buckets, out_dtype=torch.int32):
        calls.append((n_buckets, out_dtype))
        return real(keys, n_buckets, out_dtype=out_dtype)

    monkeypatch.setattr(ops, "shuffle_histogram", spy)
    got = device_histogram(_KEYS, values, vocab=300, capacity_factor=capacity_factor,
                           device="cpu", unit_weights=unit)
    want = jdevice_histogram(jnp.asarray(_KEYS), jnp.asarray(values),
                             jmake_mesh((1,), ("data",)), "data", vocab=300,
                             capacity_factor=capacity_factor)
    assert calls == ([] if kernel is None else [(300, kernel)])
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert got.counts.numpy().dtype == np.asarray(want.counts).dtype
    assert int(got.dropped) == int(want.dropped)
    assert (got.shuffled_bytes, got.buffer_bytes) == (want.shuffled_bytes,
                                                       want.buffer_bytes)


# -- quickstart ------------------------------------------------------------------

@pytest.fixture(scope="module")
def quickstart_runs(tmp_path_factory):
    mod = _load("quickstart")
    journal = tmp_path_factory.mktemp("reference_quickstart")
    real = mod.ClusterConfig

    def config(*args, **kwargs):
        if "journal_path" in kwargs:
            kwargs["journal_path"] = str(journal)
        return real(*args, **kwargs)

    mod.ClusterConfig = config
    ref, _ = _printed(mod.main)
    port, out = _printed(quickstart.main, [
        "--journal-path", str(tmp_path_factory.mktemp("port_quickstart"))])
    return ref, port, out


def test_quickstart_prints_the_reference_figures(quickstart_runs):
    ref, port, _ = quickstart_runs
    assert "transfer quota 15000 B exceeded (" in ref
    assert "resumed 11/11 tasks" in ref
    assert masked(port) == masked(ref)


def test_quickstart_quota_failure_matches_reference_on_one_invoker():
    """The quota run with one invoker: the map tasks commit one after
    another, and both packages fail at the same byte with the same text."""
    ref = _load("quickstart")
    got = {}
    for name, api, storage, mod in (("jax", japi, jstorage, ref),
                                    ("torch", tapi, tstorage, quickstart)):
        tiny = storage.DeviceSpec("s3", 90e6, 90e6, 0, 0, transfer_quota=15_000)
        with api.MarvelClient(api.ClusterConfig(
                name="quota", tiers=(api.TierSpec(device=tiny),), block_size=1 << 15,
                invokers=1)) as client:
            with pytest.raises(storage.QuotaExceededError) as err:
                mod.wordcount(client, mod.corpus())
        got[name] = str(err.value)
    assert got["torch"] == got["jax"] == (
        "s3: transfer quota 15000 B exceeded (16944 B moved) — this is the "
        "paper's 15 GB Lambda/S3 failure mode")


def test_quickstart_tiers_agree_and_the_crash_resumes_every_task(quickstart_runs):
    _, _, out = quickstart_runs
    outputs = set(out["outputs"].values())
    assert len(outputs) == 1 and next(iter(outputs))
    assert out["quota_error"] is not None
    assert out["resumed_tasks"] == out["tasks"] > 0


# -- iterative_dataflow ----------------------------------------------------------

@pytest.fixture(scope="module")
def dataflow_runs():
    ref, _ = _printed(_load("iterative_dataflow").main)
    port, out = _printed(iterative_dataflow.main, [])
    return ref, port, out


def test_iterative_dataflow_prints_the_reference_figures(dataflow_runs):
    ref, port, _ = dataflow_runs
    assert "outputs identical: True" in ref and "globally sorted: True" in ref
    assert masked(port) == masked(ref)


def test_iterative_dataflow_pagerank_bytes_match_reference():
    """The pinned PageRank's rank bytes, run directly in both packages."""
    from repro.core.workloads import pagerank_graph as jgraph
    from repro_torch.core.workloads import pagerank_graph

    js, jd = jgraph(n_nodes=500, n_edges=3000, seed=1)
    ts, td = pagerank_graph(n_nodes=500, n_edges=3000, seed=1)
    np.testing.assert_array_equal(js, ts)
    np.testing.assert_array_equal(jd, td)
    kw = dict(tol=1e-6, max_iterations=15)
    with japi.MarvelClient(japi.ClusterConfig(name="ex-pr", **iterative_dataflow.PINNED)) as c:
        want = c.pagerank("ex-pr", js, jd, 500, **kw)
    from repro_torch.api import ClusterConfig, MarvelClient

    with MarvelClient(ClusterConfig(name="ex-pr", **iterative_dataflow.PINNED)) as c:
        got = c.pagerank("ex-pr", ts, td, 500, **kw)
    assert got.result.rank_bytes == want.result.rank_bytes
    assert got.report.field("last_iteration") == want.report.field("last_iteration")


# -- serve_lm --------------------------------------------------------------------

class _Future:
    def __init__(self, fut, stream: list):
        self._fut, self._stream = fut, stream

    def result(self, *args, **kwargs):
        r = self._fut.result(*args, **kwargs)
        self._stream.append(int(np.asarray(r).reshape(-1)[0]))
        return r


class _Recorder:
    """The reference's pool, recording each conversation's prompt and
    tokens."""

    def __init__(self, pool, streams: dict, prompts: dict):
        self._pool, self._streams, self._prompts = pool, streams, prompts

    def __getattr__(self, name):
        return getattr(self._pool, name)

    def start(self, conversation, prompt, **kwargs):
        self._prompts[conversation] = np.asarray(prompt)
        return _Future(self._pool.start(conversation, prompt, **kwargs),
                       self._streams.setdefault(conversation, []))

    def step(self, conversation, **kwargs):
        return _Future(self._pool.step(conversation, **kwargs),
                       self._streams.setdefault(conversation, []))


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    mod = _load("serve_lm")
    rec = {"pools": [], "prompts": {}}
    real_init = mod.init_params

    def init_f32(defs, key):
        rec["params"] = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                               real_init(defs, key))
        return rec["params"]

    class Client(japi.MarvelClient):
        def serving(self, params, cfg, **kwargs):
            streams = {}
            rec["pools"].append(streams)
            return _Recorder(super().serving(params, cfg, **kwargs), streams,
                             rec["prompts"])

    dirs = tmp_path_factory.mktemp("reference_serve")
    mod.init_params = init_f32
    mod.MarvelClient = Client
    mod.tempfile = types.SimpleNamespace(
        mkdtemp=lambda prefix="": tempfile.mkdtemp(prefix=prefix, dir=dirs))
    ref, _ = _printed(mod.main)

    cfg = reduced_for_smoke(get_config("qwen2.5-3b"))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, rec["params"]), cfg, "cpu")
    lines = []
    out = serve_lm.run(cfg, params, rec["prompts"], "cpu",
                       workdir=tmp_path_factory.mktemp("port_serve"), log=lines.append)
    return ref, "\n".join(lines), out, rec


def test_serve_lm_prints_the_reference_figures(serve_runs):
    ref, port, _, _ = serve_runs
    assert "23 Zipf-active conversations" in ref
    assert masked(port) == masked(ref)


def test_serve_lm_decodes_the_reference_tokens(serve_runs):
    _, _, out, rec = serve_runs
    first, after = rec["pools"]
    assert out["tokens"] == first
    assert sum(map(len, first.values())) == 145
    assert after == {out["resumed"]: out["next_token"]}


def test_serve_lm_pager_counts_and_restart(serve_runs):
    _, _, out, _ = serve_runs
    stats = out["stats"]
    assert out["conversations"] == 23 == out["adopted"]
    assert stats["resident_sessions"] + stats["paged_sessions"] == 23
    assert stats["demotions"] > 0 and stats["resumes"] > 0
    assert stats["demand_faults"] == 0


def test_serve_lm_removes_its_own_directories(tmp_path, monkeypatch):
    """Without ``workdir`` the twin serves from a temporary directory and
    removes it at the end (a short trace of the same shape)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    cfg = reduced_for_smoke(get_config("qwen2.5-3b"))
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models import init_params, model_defs

    params = init_params(model_defs(cfg), gen, "cpu", dtype=torch.float32)
    monkeypatch.setattr(serve_lm, "TRACE", serve_lm.TraceSpec(
        seed=7, duration=0.5, base_rate=24.0, tenants=2, sessions_per_tenant=3))
    _, convs = serve_lm.conversations()
    prompts = {c: torch.randint(0, cfg.vocab, (1, serve_lm.PROMPT_LEN), generator=gen,
                                dtype=torch.int32) for c in convs}
    out = serve_lm.run(cfg, params, prompts, "cpu", log=lambda _: None)
    assert out["conversations"] == len(convs) == out["adopted"]
    assert list(tmp_path.iterdir()) == []
