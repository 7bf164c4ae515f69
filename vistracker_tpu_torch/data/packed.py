"""The packed-pkl contract (save / load side of vistracker_tpu/data/packed.py).

Files are plain pickles (protocol 4), which joblib.load -- the JAX
package's reader -- also reads. Conventions: poses (T, 156) axis-angle
SMPL-H, betas (T, 10), trans (T, 3), obj_angles (T, 3, 3) row-vector
rotations, recon_exist (T,) bool, frames a list of frame names.
"""
from __future__ import annotations

import os
import pickle


def save_packed(path: str, data: dict):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=4)


def load_packed(path: str) -> dict:
    """Load a packed pkl written by save_packed (only trusted files:
    unpickling runs code)."""
    with open(path, "rb") as f:
        return pickle.load(f)
