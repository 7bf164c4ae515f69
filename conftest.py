"""Set-up of every pytest process, before any test file is collected.

It loads the JAX package's native BVH library in this process through
tests/torch_jax_ref.py, which builds it in a directory of this process's
own. Without it, the pytest-xdist workers of a run on an empty temp dir
reach tests/test_native.py, whose skipifs ask the JAX loader when the file
is imported, at the same moment, and race on the loader's one shared build
name. A worker that loses skips those tests, or fails to import the file;
its collection then differs from the other workers', and xdist runs no
test at all (ROADMAP Queue 3, F2).

It is also what gives the port's tests that compare against that library
bit for bit (test_torch_sampling, _offline, _fixture_eval, _training and
_orbax) the library: the loader keeps it for the whole process.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))


def pytest_configure(config):
    from torch_jax_ref import jax_pointmesh
    try:
        jax_pointmesh()
    except AssertionError:
        # no C++ compiler: the JAX loader falls back to scipy, its own
        # tests skip, and the port's tests that compare with it fail
        pass
