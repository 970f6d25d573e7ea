"""The cases of ``tests/test_torch_families.py`` on the registry's other
five architectures: the same tests, inputs and tolerances, with this
file's own ``arch``, ``drift`` and module-scoped ``world`` fixtures (the
family tests are split over two files so that two test workers share
them)."""
import pytest

from test_torch_families import *  # noqa: F401,F403  the cases
from test_torch_families import ARCHS, DRIFT, HERE

OTHERS = tuple(a for a in ARCHS if a not in HERE)


@pytest.fixture(scope="module", params=OTHERS)
def arch(request):
    return request.param


@pytest.fixture(params=[d for d in DRIFT if d[0] in OTHERS],
                ids=lambda d: f"{d[0]}-{d[1]}")
def drift(request):
    return request.param
