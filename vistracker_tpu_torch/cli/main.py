"""vistracker_tpu_torch command line.

    python -m vistracker_tpu_torch.cli.main track \
        --seq <BEHAVE sequence> --smpl-model <SMPLH pkl> --assets <dir> \
        --objects-root <object templates> \
        --sifnet-ckpt <tar | experiment dir | random> \
        --infiller-ckpt <tar | random> \
        [--smoothnet-smpl-ckpt <tar | random>] \
        [--smoothnet-objrot-ckpt <tar | random>] [--device cpu]

Runs on the GPU (`--device cuda`, the default) unless `--device cpu` is
given; without a GPU a cuda run raises. The flags carry the names and
defaults of the JAX package's `track`; what the port does not have yet
is refused by cli/real_track.py:check_supported.
"""
from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vistracker-torch",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("track", help="tracking pipeline (stages 1-6 and "
                                      "the pack)")
    tr.add_argument("--seq", required=True, help="BEHAVE sequence folder")
    tr.add_argument("--out", default="track_out")
    tr.add_argument("--device", default="cuda",
                    help="torch device; cpu only when asked for")
    tr.add_argument("--dataset", choices=["behave", "intercap"],
                    default="behave", help="camera model")
    tr.add_argument("--kid", type=int, default=1)
    tr.add_argument("--start", type=int, default=0)
    tr.add_argument("--end", type=int, default=None)
    tr.add_argument("--chunk-size", type=int, default=96)
    tr.add_argument("--crop-size", type=int, default=1200)
    tr.add_argument("--net-size", type=int, default=512)
    tr.add_argument("--save-name", default="track")
    tr.add_argument("--smpl-model", required=True, help="SMPL-H model pkl")
    tr.add_argument("--assets", default=os.environ.get(
        "VISTRACKER_ASSETS", "assets"))
    tr.add_argument("--sifnet-ckpt", required=True,
                    help="tri-vis-l2 checkpoint (torch tar or experiment "
                         "dir), or 'random' for untrained weights")
    tr.add_argument("--objects-root", help="object template folder")
    tr.add_argument("--infiller-ckpt",
                    help="HVOP-Net (cmf-k4-lrot) checkpoint, or 'random'")
    tr.add_argument("--smoothnet-smpl-ckpt",
                    help="stage-2 SmoothNet checkpoint or 'random'; stage 2 "
                         "runs only when given")
    tr.add_argument("--smoothnet-objrot-ckpt",
                    help="stage-5 object-rotation SmoothNet checkpoint or "
                         "'random'; the smoothing runs only when given")
    tr.add_argument("--segment-iters", type=int, default=0,
                    help="accepted for the JAX package's command lines; the "
                         "stage-6 phases are host loops here, so it changes "
                         "nothing")
    tr.add_argument("--collision", action="store_true",
                    help="human-object interpenetration term in the stage-6 "
                         "joint phase (SDF-grid penalty, ops/sdf_grid.py); "
                         "builds the template SDF grid once per sequence")
    tr.add_argument("--sdf-res", type=int, default=64,
                    help="template SDF grid resolution for --collision")
    tr.add_argument("--ocent", type=float, default=0.0,
                    help="weight of the object-center anchor term in the "
                         "stage-6 object and joint phases; 0 = off, the "
                         "reference release's value")
    tr.add_argument("--early-stop", action="store_true",
                    help="enable the stage-6 relative-loss early-stop gates "
                         "(default off: fixed budgets are reference parity)")
    tr.add_argument("--smpl-query-points", type=int, default=0,
                    help="subsample SMPL vertices in the stage-6 df losses "
                         "(0 = all, reference parity)")
    tr.add_argument("--shard-frames", action="store_true",
                    help="multi-device frame sharding (refused: ROADMAP.md "
                         "Queue 1 item 6)")
    tr.add_argument("--robust-centers", action="store_true",
                    help="median instead of mean aggregation of the neural "
                         "object centers/pca over surface points")
    tr.add_argument("--fast-gen", dest="fast_gen", action="store_true",
                    default=True, help="stage-4 funnel harvest (default)")
    tr.add_argument("--no-fast-gen", dest="fast_gen", action="store_false",
                    help="reference-budget harvest (3 rounds x 10 "
                         "projection steps, no prefilter)")
    tr.add_argument("--cache-dtype", choices=("float32", "bfloat16"),
                    default="float32",
                    help="SIF-Net feature-cache storage dtype")
    tr.add_argument("--tiny-nets", action="store_true",
                    help="alias for --net-preset tiny")
    tr.add_argument("--net-preset", choices=("tiny", "small", "release"),
                    default="release")
    tr.add_argument("--redo", action="store_true",
                    help="re-run even if the packed output exists")
    tr.add_argument("--neural-only", action="store_true",
                    help="stop after stage 4 and pack the neural outputs")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "track":
        from .real_track import run_real_track
        run_real_track(args)


if __name__ == "__main__":
    main()
