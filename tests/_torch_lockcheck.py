"""The port's lock-order witness as a pytest fixture.

``tests/conftest.py``'s ``lockcheck`` marker installs the JAX package's
witness, which wraps only ``repro`` classes. A port test module applies
this fixture instead::

    from _torch_lockcheck import torch_lock_witness  # noqa: F401
    pytestmark = pytest.mark.usefixtures("torch_lock_witness")

Serving objects built inside the test get witness locks
(``repro_torch.analysis.lock_witness``), and any acquisition against the
declared order (``repro_torch.analysis.lock_order``) fails the test at
teardown.
"""
import pytest


@pytest.fixture
def torch_lock_witness():
    from repro_torch.analysis import lock_witness as lw

    session = lw.install()
    try:
        yield session
    finally:
        lw.uninstall(session)
    assert not session.violations, (
        "the port's lock-order witness recorded violation(s):\n\n"
        + "\n\n".join(str(v) for v in session.violations))
