"""The JAX package's native BVH, made usable in this process for the port's
tests that compare against it bit for bit. Not a test file.

`vistracker_tpu/native/pointmesh.py` builds its library on first use into
one shared name, `<tempdir>/vistracker_native/libpointmesh-<sha>.so.tmp`,
then renames it; `get_lib` marks the build as tried before it starts and
never tries again. Under `pytest -n` every worker collects every file, and
`tests/test_native.py` asks `available()` at collection, so on a fresh
temp dir several workers build into that one name at once. A loser gets
no library for the rest of its run (the JAX loader then falls back to
scipy), or loads a file another worker is still writing. This is fault F2
of ROADMAP Queue 3.

`jax_pointmesh()` keeps a library this process already loaded. Otherwise
it forgets the failed attempt and builds again, into a directory made for
this process alone (tempfile.tempdir points there for that one call), so
it never writes the shared name and never loads a file that another
process may still be writing.
"""
import os
import shutil
import tempfile

from vistracker_tpu.native import pointmesh as JPM


def jax_pointmesh():
    """The JAX package's `native/pointmesh.py` module, with its library
    loaded in this process."""
    if JPM._LIB is None:
        JPM._LIB, JPM._TRIED = None, False
        shared = tempfile.tempdir
        private = tempfile.mkdtemp(prefix=f"jax-pointmesh-{os.getpid()}-")
        tempfile.tempdir = private
        try:
            JPM.get_lib()
        finally:
            tempfile.tempdir = shared
            # the loaded library stays mapped after its file is gone
            shutil.rmtree(private, ignore_errors=True)
    assert JPM.available(), (
        "F2: the JAX package's native BVH (vistracker_tpu/native/"
        "pointmesh.cpp) did not build in this process's own directory; "
        "the port's tests compare against it bit for bit")
    return JPM
