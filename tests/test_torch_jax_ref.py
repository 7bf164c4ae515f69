"""tests/torch_jax_ref.py:jax_pointmesh, the port tests' way to the JAX
package's native BVH (ROADMAP Queue 3, F2).

Six processes start at once on one fresh temp dir and each asks the JAX
loader first, as six pytest workers do when they collect
tests/test_native.py: they race on the loader's one shared build name.
Each then calls jax_pointmesh(), and every one must end with the native
library, whose BVH query on a sphere equals the port's native/pointmesh.py
bit for bit. A second case marks the loader as failed by hand in this
process, as a lost race leaves it, and the helper recovers without
writing into the temp dir it was given."""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from test_torch_sampling import _sphere
from torch_jax_ref import jax_pointmesh
from vistracker_tpu.native import pointmesh as JPM
from vistracker_tpu_torch.native import pointmesh as TPM

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# one process: wait for the go file, ask the JAX loader (the race), then
# the helper; print what the loader gave and whether the BVHs agree
RACER = r"""
import json, os, sys, time
import numpy as np
go = sys.argv[1]
from vistracker_tpu.native import pointmesh as JPM
from torch_jax_ref import jax_pointmesh
from test_torch_sampling import _sphere
from vistracker_tpu_torch.native import pointmesh as TPM
while not os.path.exists(go):
    time.sleep(0.001)
try:
    first = JPM.available()
except OSError as e:      # the loader found a file still being written
    first = repr(e)
jax_pointmesh()
verts, faces = _sphere()
pts = (np.random.RandomState(0).randn(400, 3) * 0.7).astype(np.float32)
a = JPM.PointMeshBVH(verts, faces).query(pts)
b = TPM.PointMeshBVH(verts, faces).query(pts)
print(json.dumps({"first": first, "native": JPM._LIB is not None,
                  "equal": all(np.array_equal(x, y) for x, y in zip(a, b))}))
"""


def test_six_first_uses_at_once_all_get_the_native_library(tmp_path):
    TPM.get_lib()               # the port's own library, built before the race
    go = tmp_path / "go"
    env = dict(os.environ, TMPDIR=str(tmp_path / "tmp"),
               PYTHONPATH=os.pathsep.join([HERE, ROOT]))
    os.makedirs(env["TMPDIR"])
    procs = [subprocess.Popen([sys.executable, "-c", RACER, str(go)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    time.sleep(1.0)             # let every process reach the go line
    go.touch()
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=60)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    print("first available() in each process:", [o["first"] for o in outs])
    assert all(o["native"] for o in outs), outs
    assert all(o["equal"] for o in outs), outs


def test_recovers_after_a_lost_race_without_the_shared_dir(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(JPM, "_LIB", None)
    monkeypatch.setattr(JPM, "_TRIED", True)
    assert not JPM.available()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert jax_pointmesh() is JPM and JPM._LIB is not None
    assert tempfile.tempdir == str(tmp_path)
    assert os.listdir(tmp_path) == []   # private dir gone, shared unwritten
    verts, faces = _sphere()
    pts = (np.random.RandomState(1).randn(400, 3) * 0.7).astype(np.float32)
    for a, b in zip(JPM.PointMeshBVH(verts, faces).query(pts),
                    TPM.PointMeshBVH(verts, faces).query(pts)):
        np.testing.assert_array_equal(a, b)
