"""The port's copy of the rectified-flow configs against the JAX package's:
every one of the 11 configs and both default bases, key for key and value
for value (types included: a tuple stays a tuple)."""

import pytest

from pnpflow_tpu.config import rf_configs as jcfg
from pnpflow_tpu_torch.config import rf_configs as tcfg
from pnpflow_tpu_torch.utils.config import CfgNode


def _plain(node):
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    return (type(node).__name__, node)


def test_the_same_config_names():
    assert tcfg.available() == jcfg.available()
    assert len(tcfg.available()) == 11


@pytest.mark.parametrize("name", jcfg.available())
def test_config_equals_jax(name):
    got, want = tcfg.get_config(name), jcfg.get_config(name)
    assert isinstance(got, CfgNode)
    assert _plain(got) == _plain(want)


@pytest.mark.parametrize("base", ["default_cifar10_configs",
                                  "default_lsun_configs"])
def test_default_bases_equal_jax(base):
    assert _plain(getattr(tcfg, base)()) == _plain(getattr(jcfg, base)())


def test_unknown_config_raises():
    with pytest.raises(KeyError, match="Unknown RF config"):
        tcfg.get_config("nope")
