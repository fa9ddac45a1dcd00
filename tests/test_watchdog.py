"""The per-phase time limit of ``tests/_watchdog.py``, at a limit of 1 s.

The fixtures run three small suites at once, each in its own pytest process
under xdist with a conftest that registers the watchdog at ``limit=1``, and
read back their junit XML and console: one whose tests sleep in Python past
the limit in each phase, one whose test waits in C, where the signal handler
never runs and only the backstop can end it, and one whose module-scoped
fixture waits in C, for two tests.
"""

import os
import re
import signal
import subprocess
import sys
import xml.etree.ElementTree as ET

import pytest

import _watchdog

CONFTEST = """\
import _watchdog


def pytest_configure(config):
    config.pluginmanager.register(
        _watchdog.Watchdog(config, limit=1.0, grace=1.0), "watchdog")
"""

SLEEPS = """\
import time

import pytest


@pytest.fixture
def sleeps_in_setup():
    time.sleep(30)
    yield


@pytest.fixture
def sleeps_in_teardown():
    yield
    time.sleep(30)


def test_setup(sleeps_in_setup):
    pass


def test_after_setup():
    pass


def test_call():
    time.sleep(30)


def test_after_call():
    pass


def test_teardown(sleeps_in_teardown):
    pass


def test_after_teardown():
    pass
"""

WAIT_IN_C = """\
    with open({runs!r}, "a") as f:
        f.write("ran\\n")
    lock = ctypes.CDLL(None).pthread_mutex_lock
    lock.argtypes, lock.restype = [ctypes.c_void_p], ctypes.c_int
    mutex = ctypes.create_string_buffer(64)   # a default pthread mutex
    lock(mutex)
    lock(mutex)                               # waits on itself for good
"""

WAITS_IN_C = """\
import ctypes


def test_waits_in_c():
{wait}

def test_after_the_wait():
    pass
"""

FIXTURE_WAITS_IN_C = """\
import ctypes

import pytest


@pytest.fixture(scope="module")
def waits_in_c():
{wait}    yield


def test_first(waits_in_c):
    pass


def test_second(waits_in_c):
    pass


def test_without_it():
    pass
"""

OTHER = """\
def test_other_a():
    pass


def test_other_b():
    pass
"""


def _start(root, files, workers):
    """Start pytest over ``files`` in ``root`` with ``workers`` xdist
    workers and none of the plugins installed beside pytest."""
    (root / "pytest.ini").write_text("[pytest]\n")
    (root / "conftest.py").write_text(CONFTEST)
    with open(_watchdog.__file__) as f:
        (root / "_watchdog.py").write_text(f.read())
    for name, text in files.items():
        (root / name).write_text(text)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_")}
    env["PYTEST_DISABLE_PLUGIN_AUTOLOAD"] = "1"
    return subprocess.Popen(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "-p", "xdist", "-n", str(workers), "--dist", "loadfile",
         "--junitxml", str(root / "junit.xml")],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)


def _finish(proc, root):
    """(return code, console, {test name: [(outcome, message) of each
    report]})."""
    console = proc.communicate(timeout=120)[0]
    cases = {}
    for case in ET.parse(root / "junit.xml").iter("testcase"):
        bad = [c for c in case if c.tag in ("failure", "error")]
        outcome = bad[0].tag if bad else (
            "skipped" if case.find("skipped") is not None else "passed")
        message = "".join(f"{c.get('message')}\n{c.text}" for c in bad)
        cases.setdefault(case.get("name"), []).append((outcome, message))
    return proc.returncode, console, cases


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The three suites, started at once; at the end whatever is left of
    them, a hung worker too, is killed."""
    sleeps = tmp_path_factory.mktemp("sleeps")
    runs = {"sleeps": (_start(sleeps, {"test_s.py": SLEEPS}, 1), sleeps)}
    for name, test_file, text in (
            ("waits_in_c", "test_c.py", WAITS_IN_C),
            ("fixture_waits_in_c", "test_f.py", FIXTURE_WAITS_IN_C)):
        root = tmp_path_factory.mktemp(name)
        wait = WAIT_IN_C.format(runs=str(root / "runs.txt"))
        runs[name] = (_start(root, {test_file: text.format(wait=wait),
                                    "test_other.py": OTHER}, 2), root)
    yield runs
    for proc, _ in runs.values():
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()


@pytest.fixture(scope="module")
def sleeps(started):
    return _finish(*started["sleeps"])


def _finish_waiting(started, name):
    """What :func:`_finish` gives, and the lines the wait wrote."""
    proc, root = started[name]
    return _finish(proc, root) + ((root / "runs.txt").read_text(),)


@pytest.fixture(scope="module")
def waits_in_c(started):
    return _finish_waiting(started, "waits_in_c")


@pytest.fixture(scope="module")
def fixture_waits_in_c(started):
    return _finish_waiting(started, "fixture_waits_in_c")


@pytest.mark.parametrize("phase, frame", [
    ("setup", "sleeps_in_setup"), ("call", "test_call"),
    ("teardown", "sleeps_in_teardown")])
def test_a_phase_past_its_limit_fails_with_its_stack(sleeps, phase, frame):
    """The phase fails after the limit; the junit message names the
    phase and the frame that slept."""
    rc, console, cases = sleeps
    [(outcome, message)] = cases[f"test_{phase}"]
    assert outcome == ("failure" if phase == "call" else "error"), console
    assert (f"Timeout: the {phase} phase of test_s.py::test_{phase} passed"
            " its limit of 1.0 s.") in message
    assert f", in {frame}\n    time.sleep(30)" in message
    assert "Thread MainThread" in message


def test_the_file_goes_on_after_a_timeout(sleeps):
    """Each test after one that timed out passes, in the same worker."""
    rc, console, cases = sleeps
    assert rc == 1, console
    for phase in ("setup", "call", "teardown"):
        assert cases[f"test_after_{phase}"] == [("passed", "")], console
        assert re.search(r"^\[gw0\] \[ *\d+%\] PASSED "
                         rf"test_s\.py::test_after_{phase} *$", console,
                         re.M), console
    assert "crashed" not in console, console


def test_a_wait_in_c_ends_its_worker_once(waits_in_c):
    """The backstop ends the worker that waits in C. The crash report
    names the test and holds its stack; the new worker does not run it
    again, and every other test passes."""
    rc, console, cases, runs = waits_in_c
    assert rc == 1, console
    assert runs == "ran\n", console
    [(outcome, message)] = cases.pop("test_waits_in_c")
    assert outcome in ("failure", "error"), console
    assert "crashed while running 'test_c.py::test_waits_in_c'" in message
    assert "The worker ended in the call phase of test_c.py::test_waits_in_c"\
        in message
    assert 'test_c.py", line 11 in test_waits_in_c' in message
    assert cases == {name: [("passed", "")] for name in (
        "test_after_the_wait", "test_other_a", "test_other_b")}, console
    assert "1 failed, 3 passed" in console, console


def test_a_fixture_that_waits_in_c_ends_one_worker(fixture_waits_in_c):
    """A module-scoped fixture that waits in C ends one worker. The crash
    report names the test and the fixture; the fixture is not set up
    again, the other test that needs it fails at once, and the test of its
    module that does not need it passes."""
    rc, console, cases, runs = fixture_waits_in_c
    assert rc == 1, console
    assert runs == "ran\n", console
    [(outcome, message)] = cases.pop("test_first")
    assert outcome in ("failure", "error"), console
    assert "crashed while running 'test_f.py::test_first'" in message
    assert ("The worker ended in the setup phase of test_f.py::test_first,"
            " setting up its module-scoped fixture 'waits_in_c'.") in message
    assert 'test_f.py", line 14 in waits_in_c' in message
    [(outcome, message)] = cases.pop("test_second")
    assert outcome == "error", console
    assert ("Not run: setting up its fixture 'waits_in_c' for"
            " test_f.py::test_first ended a worker.") in message
    assert cases == {name: [("passed", "")] for name in (
        "test_without_it", "test_other_a", "test_other_b")}, console
    assert "1 failed, 3 passed, 1 error" in console, console


def test_this_run_bounds_each_test_at_the_limit(request):
    """The repo's root conftest registers the watchdog at ``LIMIT_S`` for
    the tests under ``tests/``, this one among them."""
    watchdog = request.config.pluginmanager.get_plugin("watchdog")
    assert (watchdog.limit, watchdog.grace) == (300.0, 60.0)
    assert request.node.nodeid.startswith(watchdog.under)
    assert watchdog.under == "tests/"
