"""The port's prefix cache against the JAX package's in the other engine
modes and models: the dense decode mode with the cache on, gemma2-2b
(sliding window, softcap) resuming over shared pages, and hymba-1.5b,
whose SSM layers turn the cache off in both packages.  The cases and
checks are ``test_torch_prefixcache.py``'s; each JAX scenario runs once per
module.
"""
import pytest
from test_torch_prefixcache import (MODES, CASES, _scenario, _serve,
                                    check_cache_on_equals_cache_off,
                                    check_counted_once_and_decref,
                                    check_matches_jax)


@pytest.mark.parametrize("name", MODES)
def test_prefix_cache_matches_jax(name):
    check_matches_jax(name)


@pytest.mark.parametrize("name", ["dense", "gemma2-window"])
def test_cache_on_equals_cache_off(name):
    check_cache_on_equals_cache_off(name)


@pytest.mark.parametrize("name", ["dense", "gemma2-window"])
def test_shared_pages_counted_once_and_decref(name):
    check_counted_once_and_decref(name)


def test_ssm_model_keeps_the_cache_off():
    """hymba has SSM layers: both packages ignore ``prefix_cache``."""
    got = _scenario("ssm-hymba", "torch")
    assert "counters" not in got["state"] and got["dropped"] is None
    assert all(got["state"]["load"][k] == 0 for k in got["state"]["load"]
               if k.startswith("prefix_"))
    assert got["state"]["events"] == []
    off, _ = _serve("torch", CASES["ssm-hymba"], cache=False)
    assert got["tokens"] == off
