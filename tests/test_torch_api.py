"""The port's façade: device validation, the autoscaler, and the part not
ported yet (``serving`` over the mixers of later slices).

On a machine without CUDA, ``device=True`` is refused unless the caller
asks for the CPU with ``device_interpret=True``, as the reference refuses
it off-TPU without interpret mode.
"""

import pytest
import torch

import repro.api as japi
from repro_torch.api import ClusterConfig, ConfigError, MarvelClient
from repro_torch.configs import get_config
from repro_torch.core.autoscale import Autoscaler, PolicySpec
from repro_torch.models import reduced_for_smoke


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_without_cuda_raises(no_cuda):
    with pytest.raises(ConfigError, match="device_interpret"):
        ClusterConfig(device=True).validate()
    with pytest.raises(ConfigError, match="device_interpret"):
        MarvelClient(ClusterConfig(device=True))
    with MarvelClient(ClusterConfig()) as c:
        # a per-call opt-in is validated the same way
        with pytest.raises(ConfigError, match="device_interpret"):
            c.terasort("ts-err", [b"a\nb"], device=True)
    ClusterConfig(device=True, device_interpret=True).validate()


def test_same_refusal_as_reference_off_accelerator(no_cuda):
    with pytest.raises(japi.ConfigError):
        japi.ClusterConfig(device=True).validate()
    with pytest.raises(ConfigError):
        ClusterConfig(device=True).validate()


def test_interpret_runs_on_the_cpu():
    with MarvelClient(ClusterConfig(device=True, device_interpret=True)) as c:
        dev = c._device_exec(None)
    assert dev.device == torch.device("cpu")


@pytest.mark.parametrize("method", ["serving"])
def test_not_ported_yet(method):
    with MarvelClient(ClusterConfig()) as c:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            # attention and Mamba-2 are ported, MLA not
            cfg = reduced_for_smoke(get_config("deepseek-v2-lite-16b"))
            c.serving({}, cfg, prompt_len=4, max_tokens=2, device="cpu")


def test_autoscaler_is_ported_with_spec_overrides():
    with MarvelClient(ClusterConfig(invokers=2)) as c:
        auto = c.autoscaler(max_invokers=5, target_per_invoker=3,
                            interval_s=0.25)
        assert isinstance(auto, Autoscaler)
        assert auto.spec == PolicySpec(max_invokers=5, target_per_invoker=3)
        assert auto.interval_s == 0.25
        assert auto._gateways() == {"n0": c.gateway}
        base = PolicySpec(min_invokers=2, max_invokers=3)
        over = c.autoscaler(base, min_invokers=1)
        assert over.spec == PolicySpec(min_invokers=1, max_invokers=3)
        assert c.autoscaler(base).spec is base
