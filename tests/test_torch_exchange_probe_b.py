"""The second half of ``test_torch_exchange_probe.py``'s seeded random
partitioned queries, in a file of its own so that parallel test workers
share the cases."""
import pytest

from test_torch_exchange_probe import N_CASES, run_case


@pytest.mark.parametrize("seed", range(N_CASES, 2 * N_CASES))
def test_random_partitioned_query(seed):
    run_case(seed)
