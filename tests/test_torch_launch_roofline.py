"""The port's roofline arithmetic against the JAX package's
``repro.launch.roofline``, no processes.

* ``model_flops_for`` equal to the reference's for every config and input
  shape, and beside it ``param_count`` / ``active_param_count`` (the
  counts it reads).
* ``_wire_factor`` equal to the reference's for each of the five HLO
  collective kinds at group sizes 1, 2, 4 and 16."""
import pytest

from repro import configs as jconfigs
from repro.launch import roofline as jroof
from repro_torch import configs
from repro_torch.launch import roofline

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_model_flops_for_matches_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert list(configs.INPUT_SHAPES) == list(jconfigs.INPUT_SHAPES)
    for name, shape in configs.INPUT_SHAPES.items():
        want = jroof.model_flops_for(jcfg, jconfigs.INPUT_SHAPES[name])
        assert roofline.model_flops_for(cfg, shape) == want, name


@pytest.mark.parametrize("kind", KINDS)
def test_wire_factor_matches_reference(kind):
    for g in (1, 2, 4, 16):
        assert roofline._wire_factor(kind, g) == jroof._wire_factor(kind, g)
