"""The port's façade: device validation and the parts not ported yet
(``autoscaler``, and ``serving`` over the mixers of later slices).

On a machine without CUDA, ``device=True`` is refused unless the caller
asks for the CPU with ``device_interpret=True``, as the reference refuses
it off-TPU without interpret mode.
"""

import pytest
import torch

import repro.api as japi
from repro_torch.api import ClusterConfig, ConfigError, MarvelClient
from repro_torch.configs import get_config
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


@pytest.mark.parametrize("method", ["serving", "autoscaler"])
def test_not_ported_yet(method):
    with MarvelClient(ClusterConfig()) as c:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            if method == "serving":  # attention and Mamba-2 are ported, MLA not
                cfg = reduced_for_smoke(get_config("deepseek-v2-lite-16b"))
                c.serving({}, cfg, prompt_len=4, max_tokens=2, device="cpu")
            else:
                c.autoscaler()
