"""A test module's temporary directories, removed when the module ends.

A full run of the port's tests leaves gigabytes of checkpoints, micro
datasets and eval outputs under pytest's basetemp otherwise (7.0 GB, most
of it from the CLI, config and DDP files), and pytest keeps the last three
runs' basetemps. A module that imports both fixtures has each of its tests'
`tmp_path` removed at the module's end; its module-scoped fixtures add the
directories they make to `module_tmp_dirs`."""
import shutil

import pytest


@pytest.fixture(autouse=True, scope="module")
def module_tmp_dirs():
    """The directories to remove when the module ends."""
    dirs = []
    yield dirs
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(autouse=True)
def collect_tmp_path(request, module_tmp_dirs):
    """Each test's tmp_path, when it has one, into module_tmp_dirs."""
    yield
    path = request.node.funcargs.get("tmp_path")
    if path is not None:
        module_tmp_dirs.append(path)
