import os

# Tests run on the CPU with a virtual 8-device mesh, so sharding tests work
# anywhere and never take a GPU from a measurement.  The tests marked `gpu`
# run where JAX_PLATFORMS names cuda (e.g. "cuda,cpu"), on the card.
if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# Persistent compilation cache (utils/jaxcache.py): the Viterbi lax.scan
# programs are slow to compile on CPU.
from deciphon_tpu.utils.jaxcache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy mesh cases excluded from the fast tier "
        "(pytest -m 'not slow' runs in minutes; run the full suite before "
        "releases)")
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (the CUDA kernel has no CPU mode); skips "
        "elsewhere.  Run on a card with: JAX_PLATFORMS=cuda,cpu python -m "
        "pytest tests/ -m gpu -p no:cacheprovider")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip where there is none.  Decided here, at run
    time, never while a module is imported."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("no GPU: the CUDA kernel runs only on the card")
    return devs[0]


class OracleScorer:
    """Per-window, unpadded viterbi_jax scoring: the reference the batched
    scorers are held to (scorer contract: score(items) ->
    {id(item): (null_cost, alt_cost)})."""

    def __init__(self, costs_list):
        self.costs = costs_list

    def score(self, items):
        import jax.numpy as jnp

        from deciphon_tpu.ops.viterbi_jax import viterbi, viterbi_null
        from deciphon_tpu.xtrans import XT_RR

        out = {}
        for it in items:
            c = self.costs[it.p_idx]
            codes = jnp.asarray(it.codes)
            L = jnp.int32(it.win.length)
            alt = viterbi(jnp.asarray(c.core), jnp.asarray(c.match),
                          jnp.asarray(c.null), jnp.asarray(c.background),
                          jnp.asarray(it.xt), codes, L)
            nul = viterbi_null(jnp.asarray(c.null),
                               jnp.float32(it.xt[XT_RR]), codes, L)
            out[id(it)] = (float(nul), float(alt))
        return out


@pytest.fixture
def oracle_scorer():
    return OracleScorer
