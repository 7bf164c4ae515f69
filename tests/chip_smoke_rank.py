"""One rank of chip_smoke.py's sharded `track` phase, rehearsed on the
CPU at toy size for tests/test_torch_chip_smoke.py:

    python chip_smoke_rank.py <work dir> <frames> <chunk>

with torchrun's variables set. The stage budgets are cut as in the
other CPU rehearsals of the main path, and the kernel wrappers are
wrapped to count their calls (the CPU path launches nothing), then
chip_smoke.shard_rank runs with --device cpu. Imports no JAX."""
import functools
import os
import sys

import torch

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from vistracker_tpu_torch.fit import generator, joint, smplt  # noqa: E402
from vistracker_tpu_torch.ops import coverage, label_nn  # noqa: E402

# the budgets and harvest sizes of the CPU rehearsal (test_torch_track.py)
BUDGETS = dict(smplt=dict(global_iters=1, max_iters=1),
               joint=dict(smpl_max_iter=1, iter_obj=1, iter_sil=1,
                          joint_max_iter=1, sil_size=16, sil_sigma=1 / 8),
               generator=dict(num_points=32),
               funnel=((256, 128, 2), (128, 64, 2)))
TOY = dict(extra=("--tiny-nets", "--net-size", "64"), mesh=(12, 10),
           obj=(6, 8), sil_size=32)


def counting(fn):
    def wrapped(*a, **k):
        wrapped.launches += 1
        return fn(*a, **k)
    wrapped.launches = 0
    return wrapped


def cut_budgets():
    orig = smplt.SMPLTFitConfig
    smplt.SMPLTFitConfig = lambda *a, **k: orig(**BUDGETS["smplt"])
    joint.JointFitConfig = functools.partial(joint.JointFitConfig,
                                             **BUDGETS["joint"])
    generator.GeneratorConfig = functools.partial(generator.GeneratorConfig,
                                                  **BUDGETS["generator"])
    generator.FUNNEL_DEFAULT = BUDGETS["funnel"]
    # shard_rank builds its configs at chip_smoke's main-path budgets
    chip_smoke.MAIN_FIT = BUDGETS["smplt"]
    chip_smoke.MAIN_JOINT = {k: BUDGETS["joint"][k]
                             for k in chip_smoke.MAIN_JOINT}
    coverage.max_logit_fwd = counting(coverage.max_logit_fwd)
    coverage.max_logit_bwd = counting(coverage.max_logit_bwd)
    label_nn.label_nn_fwd = counting(label_nn.label_nn_fwd)


if __name__ == "__main__":
    work, frames, chunk = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    chip_smoke.WORK = work
    cut_budgets()
    chip_smoke.shard_rank(frames, chunk, "cpu", **TOY)
