"""The port's blob codec against the reference package's.

Blobs written by ``repro.storage.serde`` load in the port to equal values
(bf16 as ``torch.bfloat16``); the port round-trips its own blobs byte for
byte; and both packages lay out the same tree the same way, so each loads
the other's blobs.
"""

import json
import struct
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.optim.adamw import OptState
from repro_torch.optim.adamw import OptState as TOptState
from repro.storage import serde as jserde
from repro_torch.storage import serde as tserde


class Point(NamedTuple):
    x: object
    y: object


def _tree(rng):
    return {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "i64": np.arange(5, dtype=np.int64),
        "u8": rng.integers(0, 255, (2, 3, 2)).astype(np.uint8),
        "scalars": [1, 2.5, "s", True, None],
        "nested": {"b": (np.int32(7), [np.zeros(0, np.float16)]), "a": {}},
        "point": Point(np.ones(2, np.float64), {"z": 3}),
    }


def _split(blob):
    """(header, structure line) of a blob."""
    off = len(b"MRVL1\n")
    (hlen,) = struct.unpack_from("<Q", blob, off)
    off += 8
    header = json.loads(blob[off : off + hlen])
    nl = blob.index(b"\n", off + hlen)
    return header, blob[off + hlen : nl]


def _assert_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _assert_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_equal(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want and type(got) is type(want)


def test_port_loads_reference_blobs(rng):
    tree = _tree(rng)
    got = tserde.loads(jserde.dumps(tree))
    _assert_equal(got, jserde.loads(jserde.dumps(tree)))


def test_bf16_crosses_both_ways(rng):
    vals = rng.standard_normal((4, 3)).astype(np.float32)
    jblob = jserde.dumps({"w": jnp.asarray(vals, jnp.bfloat16)})
    t = tserde.loads(jblob)["w"]
    assert t.dtype == torch.bfloat16
    want = torch.from_numpy(vals).to(torch.bfloat16)
    assert torch.equal(t, want)
    tblob = tserde.dumps({"w": want})
    assert _split(tblob)[0]["leaves"] == _split(jblob)[0]["leaves"]
    back = jserde.loads(tblob)["w"]
    np.testing.assert_array_equal(
        np.asarray(back, np.float32), want.float().numpy()
    )


def test_port_round_trips_its_own_blobs(rng):
    base = _tree(rng)
    tree = dict(
        base,
        t=torch.arange(6, dtype=torch.int32).reshape(2, 3),
        bf=torch.linspace(-1, 1, 5).to(torch.bfloat16),
    )
    blob = tserde.dumps(tree)
    back = tserde.loads(blob)
    assert tserde.dumps(back) == blob  # the VersionedCodec.prime contract
    np.testing.assert_array_equal(back["t"], tree["t"].numpy())
    assert torch.equal(back["bf"], tree["bf"])
    assert isinstance(back["point"], Point)
    assert tserde.leaf_bytes(tree) == jserde.leaf_bytes(base) + 6 * 4 + 5 * 2


def test_same_layout_as_reference(rng):
    tree = _tree(rng)
    jblob, tblob = jserde.dumps(tree), tserde.dumps(tree)
    (jh, js), (th, ts) = _split(jblob), _split(tblob)
    assert ts == js  # structure line: sorted dict keys, NamedTuple class
    assert th["leaves"] == jh["leaves"]
    _assert_equal(jserde.loads(tblob), jserde.loads(jblob))


@pytest.mark.parametrize("cls,expect", [
    # repro.optim.adamw:OptState resolves to the port's OptState (the id
    # keeps the name it had while repro.optim was unported)
    pytest.param(OptState, TOptState, id="OptState-tuple"),
    (Point, Point),  # a class outside both packages resolves as is
])
def test_namedtuple_resolution(cls, expect):
    value = cls(*range(len(cls._fields)))
    got = tserde.loads(jserde.dumps(value))
    assert type(got) is expect
    assert tuple(got) == tuple(value)


def test_reference_class_path_maps_into_the_port():
    from repro_torch.core.dag import TaskSpec

    assert tserde._resolve_namedtuple("repro.core.dag:TaskSpec") is TaskSpec
