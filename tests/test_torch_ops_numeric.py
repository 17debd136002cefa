"""The 16 OpTest cases of tests/test_ops_numeric.py on the port, through
tests/torch_op_test.py: each case's own setup (the same inputs, numpy
expectations and attrs) and test method (the same checks and tolerances),
with the port's OpTest in place of the JAX package's. The outputs are held
to numpy and the analytic gradients (``calc_gradient``) to central
differences: an oracle for every op these cases cover that does not
depend on the JAX package.
"""
import pytest

import test_ops_numeric as cases
from torch_op_test import OpTest

CASES = sorted(name for name, c in vars(cases).items()
               if isinstance(c, type) and issubclass(c, cases.OpTest) and
               c is not cases.OpTest)


def test_all_sixteen_cases_are_here():
    assert len(CASES) == 16


@pytest.mark.parametrize("name", CASES)
def test_case_on_the_port(name):
    case = getattr(cases, name)
    on_port = type(name, (OpTest,), {"op_type": case.op_type,
                                     "setup": case.setup})
    case.test(on_port())
