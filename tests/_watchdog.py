"""A time limit for every phase of every test, without a plugin.

The repo's root ``conftest.py`` registers :class:`Watchdog` with
:data:`LIMIT_S` for the tests under ``tests/``. Each phase of a test (setup,
call, teardown) gets the limit anew:

* An interval timer (``SIGALRM``) in the main thread fails the phase when it
  runs out. The failure message holds every thread's Python stack, so under
  pytest-xdist it reaches the console and the junit XML, and names the test.
  The worker goes on with the rest of its tests.
* A wait that never comes back to Python (a lock, a collective, an OpenMP
  barrier) never runs the signal handler. For that, ``faulthandler`` ends the
  process :data:`GRACE_S` after the limit, once it has written every
  thread's stack. Under xdist it writes them to a note that names the test,
  and the fixture it was setting up if any; the controller adds the note to
  the crash report xdist makes for the test. The workers that go on do not
  run the test again, and fail at once, without setting it up, each test
  that would set up that fixture again: in the same module for a
  module-scoped fixture, in any module for a session-scoped one. So a wait in
  a fixture costs one worker, not one a test.
"""

import faulthandler
import os
import signal
import sys
import tempfile
import threading
import traceback

import pytest
from _pytest.runner import runtestprotocol

LIMIT_S = 300.0  # each phase of each test; about 6x the slowest phase seen
GRACE_S = 60.0   # after the limit, before a wait in C ends the process


def thread_stacks(main_frame=None) -> str:
    """Every thread's Python stack, the main thread first and from
    ``main_frame`` when given (the frame a signal interrupted)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    main = threading.main_thread().ident
    frames = sys._current_frames()
    if main_frame is not None:
        frames[main] = main_frame
    return "\n".join(
        f"Thread {names.get(ident, '?')} ({ident}), most recent call last:\n"
        + "".join(traceback.format_stack(frames[ident]))
        for ident in sorted(frames, key=lambda i: i != main))


def _within(nodeid: str, scope: str) -> bool:
    """Whether the test ``nodeid`` lies in the node ``scope`` (the session's
    id is empty)."""
    return (not scope or nodeid == scope
            or nodeid.startswith((scope + "::", scope + "/")))


class Watchdog:
    """Bounds each phase of each test whose id starts with ``under`` at
    ``limit`` seconds; see the module's doc.

    Under xdist the controller makes a directory of notes, one file a
    worker. While a phase runs, its worker's note holds three lines: the
    test's id; the fixture being set up and the id of the node it is set up
    for, tab-separated, or nothing; and what the worker was doing. The
    backstop appends the stacks to it before it ends the worker, and the
    controller marks the note of a worker that crashed with a file beside it.
    """

    def __init__(self, config, limit=LIMIT_S, grace=GRACE_S, under=""):
        self.limit = limit
        self.grace = grace
        self.under = under
        workerinput = getattr(config, "workerinput", {})
        self.notes = workerinput.get("watchdog_notes")
        self.worker = workerinput.get("workerid")
        if self.notes is None:
            # No notes (the xdist controller, or a run without xdist): the
            # backstop writes to the real stderr, as pytest's faulthandler.
            self.fd = os.dup(sys.stderr.fileno())
        else:
            self.fd = os.open(os.path.join(self.notes, self.worker),
                              os.O_RDWR | os.O_CREAT | os.O_TRUNC)
        self.phase = None   # (test id, what it runs) while a phase is bounded
        self.noted = ""
        self.dead = set()   # the notes of workers that ended
        self.ended = set()  # tests that ended a worker, not to run again
        self.hung = []      # (fixture, node id, test) that ended a worker

    # -- each phase, in a worker or in a run without xdist ------------------

    def _note(self, text: str) -> None:
        self.noted = text
        if self.worker is not None:
            os.ftruncate(self.fd, 0)
            os.lseek(self.fd, 0, os.SEEK_SET)
            os.write(self.fd, text.encode())

    def _bounded(self, item, when):
        if not item.nodeid.startswith(self.under):
            return (yield)
        what = f"the {when} phase of {item.nodeid}"

        def expire(signum, frame):
            pytest.fail(f"Timeout: {what} passed its limit of {self.limit} s."
                        "\n\n" + thread_stacks(frame), pytrace=False)

        self.phase = (item.nodeid, what)
        self._note(f"{item.nodeid}\n\nThe worker ended in {what}.\n")
        faulthandler.dump_traceback_later(self.limit + self.grace,
                                          exit=True, file=self.fd)
        timer = threading.current_thread() is threading.main_thread()
        if timer:
            previous = signal.signal(signal.SIGALRM, expire)
            signal.setitimer(signal.ITIMER_REAL, self.limit)
        try:
            return (yield)
        finally:
            if timer:
                signal.setitimer(signal.ITIMER_REAL, 0)
                signal.signal(signal.SIGALRM, previous)
            faulthandler.cancel_dump_traceback_later()
            self.phase = None
            self._note("")

    @pytest.hookimpl(wrapper=True)
    def pytest_fixture_setup(self, fixturedef, request):
        """While a fixture is set up, the note names it and the node it is
        set up for (a fixture sets up only fixtures of its scope or wider,
        so the innermost one is the widest)."""
        if self.phase is None:
            return (yield)
        nodeid, what = self.phase
        outer = self.noted
        self._note(f"{nodeid}\n{fixturedef.argname}\t{request.node.nodeid}\n"
                   f"The worker ended in {what}, setting up its "
                   f"{fixturedef.scope}-scoped fixture {fixturedef.argname!r}"
                   ".\n")
        try:
            return (yield)
        finally:
            self._note(outer)

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_setup(self, item):
        if item.nodeid in self.ended:
            pytest.fail(f"{item.nodeid} ended a worker; not run again.",
                        pytrace=False)
        for fixture, scope, test in self.hung:
            if fixture in item.fixturenames and _within(item.nodeid, scope):
                pytest.fail(f"Not run: setting up its fixture {fixture!r} "
                            f"for {test} ended a worker.", pytrace=False)
        return (yield from self._bounded(item, "setup"))

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_call(self, item):
        return (yield from self._bounded(item, "call"))

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_teardown(self, item):
        return (yield from self._bounded(item, "teardown"))

    @pytest.hookimpl(tryfirst=True)
    def pytest_runtest_protocol(self, item, nextitem):
        """xdist hands the test a dead worker was in to the next worker.
        Its report is the controller's crash report, so here it fails its
        setup without a report, and the fixtures around it are torn down
        as usual."""
        if self.worker is None or not item.nodeid.startswith(self.under):
            return None
        self._learn(item.nodeid)
        if item.nodeid not in self.ended:
            return None
        runtestprotocol(item, log=False, nextitem=nextitem)
        return True

    def _learn(self, nodeid: str) -> None:
        """Reads the notes of workers that ended: those the controller has
        marked, and any other worker's note that names this test (xdist
        hands each test to one worker at a time, so that worker is gone)."""
        names = set(os.listdir(self.notes))
        for name in names - self.dead - {self.worker}:
            if name.endswith(".ended"):
                continue
            with open(os.path.join(self.notes, name)) as f:
                test, fixture = f.readline(), f.readline()
            if name + ".ended" in names or test == nodeid + "\n":
                self.dead.add(name)
                self.ended.add(test[:-1])
                if fixture.strip("\n"):
                    self.hung.append(
                        (*fixture.strip("\n").split("\t", 1), test[:-1]))

    # -- the xdist controller ---------------------------------------------

    @pytest.hookimpl(optionalhook=True)
    def pytest_configure_node(self, node):
        if self.notes is None:
            self.notes = tempfile.mkdtemp(prefix="watchdog-")
        node.workerinput["watchdog_notes"] = self.notes

    @pytest.hookimpl(optionalhook=True)
    def pytest_handlecrashitem(self, crashitem, report, sched):
        note = os.path.join(self.notes, report.node.gateway.id)
        with open(note) as f:
            text = f.read()
        if text.startswith(crashitem + "\n"):
            what = text.split("\n", 2)[2]   # what it did, and the stacks
            report.longrepr = f"{report.longrepr}\n\n{what}"
            open(note + ".ended", "w").close()

    def pytest_unconfigure(self, config):
        os.close(self.fd)
        if self.worker is None and self.notes is not None:
            for name in os.listdir(self.notes):
                os.remove(os.path.join(self.notes, name))
            os.rmdir(self.notes)
