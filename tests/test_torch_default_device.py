"""The port's tensor-making entry points put their tensors on the card
unless the caller asks otherwise, as the rest of the port does.

``init_cache``, ``init_ssm_cache`` and ``from_jax_params`` take
``device=None`` to mean the GPU.  A ``meta`` tensor stands in for the
card where a test needs a placement it can check without one.
"""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import (
    from_jax_params,
    init_cache,
    init_params,
    model_defs,
    reduced_for_smoke,
)
from repro_torch.models import convert, ssm, transformer
from repro_torch.models.param import default_device
from repro_torch.models.ssm import init_ssm_cache


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)


def _make(entry, **kw):
    """A small tree from ``entry``: a qwen cache, a Mamba-2 state, or a
    parameter tree carried across from CPU tensors."""
    if entry == "init_cache":
        return init_cache(reduced_for_smoke(get_config("qwen2.5-3b")), 1, 4, **kw)
    cfg = reduced_for_smoke(get_config("mamba2-2.7b"))
    if entry == "init_ssm_cache":
        return init_ssm_cache(cfg, 1, torch.float32, **kw)
    tree = init_params(model_defs(cfg), torch.Generator().manual_seed(0), "cpu")
    return from_jax_params(tree, cfg, **kw)


def test_default_device_is_the_card():
    assert default_device() == torch.device("cuda")
    assert default_device(None) == torch.device("cuda")
    for asked in ("cpu", "meta", torch.device("cuda", 1)):
        assert default_device(asked) == torch.device(asked)


ENTRIES = ["init_cache", "init_ssm_cache", "from_jax_params"]


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_an_asked_device_is_kept(entry, device):
    leaves = list(_leaves(_make(entry, device=device)))
    assert leaves and all(t.device.type == device for t in leaves)


@pytest.mark.parametrize("entry", ENTRIES)
def test_no_device_means_the_card(entry, monkeypatch):
    """The entry resolves its default through ``default_device`` to the
    card and makes its tensors there; ``meta`` stands in for the card, so
    this holds on a machine with or without one."""
    resolved = []

    def spy(device=None):
        d = default_device(device)
        resolved.append(d)
        return torch.device("meta") if d.type == "cuda" else d

    for module in (convert, ssm, transformer):
        monkeypatch.setattr(module, "default_device", spy)
    leaves = list(_leaves(_make(entry)))
    assert resolved and all(d == torch.device("cuda") for d in resolved)
    assert leaves and all(t.device.type == "meta" for t in leaves)
