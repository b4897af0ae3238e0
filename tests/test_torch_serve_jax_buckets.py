"""The served few-step bucket (``steps=1`` from a 2-step inversion) and the
``uniform:2`` deep-feature reuse request through the JAX ``EditEngine`` and
the port's, on identical tiny weights: both ``done`` with ``src_err ==
0.0``, videos within 1e-2 (each engine edits from its own capture; see
``tests/test_torch_serve_jax.py``).

The port's engine is warmed with both variants, as a server would be. The
JAX engine is not warmed (its warm-up would build the base edit too, which
this file does not serve): its admission lists are given the two variants,
and each builds on its first request.
"""

import pytest

from tests.test_torch_serve_jax import assert_served_alike, paired_engines, serve_both


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    jeng, peng = paired_engines(tmp_path_factory.mktemp("serve_buckets"),
                                port_warm=dict(step_buckets=(1,),
                                               reuse_schedules=("uniform:2",)))
    jeng.warm_steps.add(1)
    jeng.warm_reuse.add("uniform:2")
    yield jeng, peng
    jeng.close()
    peng.close()


@pytest.mark.parametrize("overrides", [{"steps": 1}, {"reuse_schedule": "uniform:2"}],
                         ids=["steps1", "reuse_uniform2"])
def test_bucket_request_matches_jax(engines, overrides):
    jeng, peng = engines
    jrec, prec, jvid, pvid = serve_both(jeng, peng, **overrides)
    assert_served_alike(jrec, prec, jvid, pvid)
    assert prec["steps"] == overrides.get("steps", 2)
    assert prec["compile_events"] == 0 and prec["program_cache_misses"] == 0
