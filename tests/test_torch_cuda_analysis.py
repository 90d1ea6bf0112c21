"""The contract gate's seven programs on the card: each meets its contract
with no host sync under ``torch.cuda.set_sync_debug_mode("error")`` on the
gate's (1, 4) mesh (four cards when there are four, else four positions on
``cuda:0``), and a seeded ``.item()`` in a step raises under the mode.
Imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_analysis.py

Without a card every test here skips."""

import pytest
import torch

from repro_torch.analysis import checks, contracts, gate, registry
from repro_torch.core import types

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def ctx():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return gate.build_context(gate.make_mesh("cuda"))


@pytest.fixture(scope="module")
def static(ctx):
    return gate.run_static(ctx)


@pytest.mark.parametrize("name", sorted(registry.discover()))
def test_program_meets_its_contract_on_the_card(static, name):
    rec = static[0][name]
    assert rec["violations"] == []
    assert rec["measured"]["host_syncs"] == []


def test_seeded_item_raises_under_the_sync_debug_mode(ctx):
    built = registry.get("fabric_step/shard/d1").builder(ctx)
    st, v = built.fn(*built.args)
    args = built.again((st, v))
    with checks.cuda_sync_guard([ctx.mesh.first]):
        with pytest.raises(RuntimeError, match="synchroniz"):
            built.fn(*args)[1].any().item()


def test_retrace_workload_and_lint_on_the_card(ctx):
    auditor = gate.run_retrace(ctx.mesh, types.TEST_DIMS)
    assert not auditor.violations
    assert auditor.programs["pipeline/window_step/d2"].calls == 5
    assert gate.run_lint() == []
    assert contracts.commit_scatter_passes() == 1
