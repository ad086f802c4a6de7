"""``repro_torch.models.make_model`` against the reference's
``repro.models.make_model``: the same arch name, or the same
``ArchConfig`` (the port's and the reference's are separate classes with
the same fields), gives a model of the same config and the same plan
segments.  Nothing is allocated: a ``Model`` builds its plan on
construction and its parameters only when asked."""
import dataclasses

import pytest

from repro.configs import get_arch as jget_arch
from repro.models import make_model as jmake_model
from repro_torch.configs import all_archs
from repro_torch.configs import get_arch as tget_arch
from repro_torch.models import Model, make_model


def _segments(plan) -> list:
    return [dataclasses.asdict(seg) for seg in plan]


@pytest.mark.parametrize("name", all_archs())
def test_make_model_by_name_matches_the_reference(name):
    got = make_model(name, device="cpu")
    want = jmake_model(name)
    assert isinstance(got, Model) and str(got.device) == "cpu"
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    assert _segments(got.plan) == _segments(want.plan)


@pytest.mark.parametrize("name", ["llama3.2-1b", "qwen2-moe-a2.7b",
                                  "xlstm-350m", "hymba-1.5b",
                                  "seamless-m4t-medium", "deepseek-v3-671b"])
def test_make_model_of_a_config_matches_the_reference(name):
    """An ``ArchConfig`` (reduced, with its depth changed) is taken as it
    is, by both packages; ``Model``'s own options pass through."""
    cfg = dataclasses.replace(tget_arch(name).reduced(), n_layers=3)
    jcfg = dataclasses.replace(jget_arch(name).reduced(), n_layers=3)
    got = make_model(cfg, device="cpu", capacity_factor=2.0)
    want = jmake_model(jcfg)
    assert got.cfg is cfg and got.capacity_factor == 2.0
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    assert _segments(got.plan) == _segments(want.plan)
