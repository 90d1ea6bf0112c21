"""The P-I+II rungs of the peer ladder, whole-block and tiled (``tx_par``
16) endorsement checks, on the port's engine against the JAX engine; the
checks are those of ``test_torch_ladder.py``. The JAX side runs once for
the module."""

import pytest

from test_torch_ladder import check_from_carried, check_from_genesis, run_jax

NAMES = ("P-I+II", "P-I+II tiled")


@pytest.fixture(scope="module")
def jax_runs():
    return run_jax(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_ladder_matches_jax_from_genesis(jax_runs, name):
    check_from_genesis(jax_runs[name], name)


@pytest.mark.parametrize("name", NAMES)
def test_ladder_matches_jax_from_carried_state(jax_runs, name):
    check_from_carried(jax_runs[name], name)
