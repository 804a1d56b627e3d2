"""The per-test time limit of ``tests/conftest.py``: a test that hangs fails
on its own within the limit, with the line it waited on, and the run goes on.

The conftest is copied next to a temporary test file and pytest runs on it in
a child process, alone and on an xdist worker; the two tests that hang carry
a limit of 2 s."""

import os
import shutil
import subprocess
import sys
import textwrap
import xml.etree.ElementTree as ET
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent

CASES = '''
import threading

import pytest


@pytest.fixture
def stuck():
    threading.Event().wait()   # the fixture's wait
    yield


@pytest.mark.time_limit(2)
def test_hangs():
    never = threading.Event()
    never.wait()   # the call's wait


@pytest.mark.time_limit(2)
def test_hangs_in_set_up(stuck):
    pass


def test_passes():
    assert True
'''


@pytest.mark.parametrize("workers", [[], ["-p", "xdist", "-n", "1"]],
                         ids=["in-process", "xdist"])
def test_a_hang_fails_alone_and_the_run_goes_on(tmp_path, workers):
    shutil.copy(HERE / "conftest.py", tmp_path / "conftest.py")
    (tmp_path / "test_cases.py").write_text(textwrap.dedent(CASES))
    xml = tmp_path / "out.xml"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", *workers, f"--junitxml={xml}",
         "test_cases.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stdout + out.stderr

    cases = {c.get("name"): c for c in ET.parse(xml).iter("testcase")}
    assert set(cases) == {"test_hangs", "test_hangs_in_set_up",
                          "test_passes"}
    for name, phase, line in [("test_hangs", "call", "never.wait()"),
                              ("test_hangs_in_set_up", "set-up",
                               "threading.Event().wait()")]:
        case = cases[name]
        failed = case.find("failure")
        if failed is None:
            failed = case.find("error")     # a set-up fault is an error
        assert failed is not None, name
        assert float(case.get("time")) < 15.0, (name, case.get("time"))
        text = failed.get("message", "") + (failed.text or "")
        assert f"{phase} ran past its time limit of 2 s" in text, text
        assert line in text, text
    assert all(e.tag in ("system-out", "system-err")
               for e in cases["test_passes"])
