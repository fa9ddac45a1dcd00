"""Registers the time limit of ``tests/_watchdog.py`` for the tests under
``tests/``: each phase of each test gets ``_watchdog.LIMIT_S`` seconds, so a
test that hangs fails with its stacks and the run goes on to its end.

``tests/_watchdog.py`` is loaded by its path, under the name the tests import
it by (``tests/`` is on their path, not on this file's).
"""

import importlib.util
import os
import sys

_TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")


def _watchdog():
    if "_watchdog" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "_watchdog", os.path.join(_TESTS, "_watchdog.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules["_watchdog"] = module
        spec.loader.exec_module(module)
    return sys.modules["_watchdog"]


def pytest_configure(config):
    watchdog = _watchdog()
    config.pluginmanager.register(
        watchdog.Watchdog(config, under="tests/"), "watchdog")
