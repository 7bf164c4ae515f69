"""Stage-6 chunk-size (B) ladder of the port: accuracy against throughput.

The port's counterpart of scripts/b_ladder.py. Smaller chunks cut the
temporal stencils of stage 6 at more chunk boundaries. This script
re-tracks the fixture sequence of a run_fixture_eval_torch.py run folder
at several --chunk-size values with the same trained checkpoints and
budgets (its track and eval phases with --recon-tag b<B>, so the recon
folders do not collide), evaluates each against the GT pack and writes
one table, {B: {smpl_v2v_cm, obj_v2v_cm, smpl_chamf_cm, obj_chamf_cm,
fps_tracked, track_wall_s}}, to results/b_ladder_torch.json. A size
already in the table is skipped.

On the 90-frame fixture B = 90 is one chunk: the stencils are never cut.

Usage: python scripts/b_ladder_torch.py --out fixture_run_rel
       --net-preset release [--sizes 8,30,90] [--device cpu]
"""
import argparse
import json
import os
import os.path as osp
import subprocess
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))


def log(msg):
    print(f"[b_ladder {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="fixture_run_rel")
    ap.add_argument("--net-preset", default="release")
    ap.add_argument("--object-shape", default="lbox")
    ap.add_argument("--sizes", default="8,30,90")
    ap.add_argument("--results", default="results/b_ladder_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the track and eval phases")
    ap.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                    help="further run_fixture_eval_torch.py options (the "
                         "run's sizes: --frames, --raster, --net-size, ...)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",")]
    runner = osp.join(osp.dirname(osp.abspath(__file__)),
                      "run_fixture_eval_torch.py")
    report = {"out": args.out, "net_preset": args.net_preset, "ladder": {}}
    if osp.isfile(args.results):
        with open(args.results) as f:
            report = json.load(f)
    for B in sizes:
        key = str(B)
        if "obj_v2v_cm" in report["ladder"].get(key, {}):
            log(f"B={B} already measured, skipping")
            continue
        tag = f"b{B}"
        res_json = osp.join(args.out, f"eval_torch_{tag}.json")
        base = [sys.executable, runner, "--out", args.out,
                "--net-preset", args.net_preset,
                "--object-shape", args.object_shape,
                "--chunk-size", str(B), "--recon-tag", tag,
                "--results", res_json, "--device", args.device, *args.extra]
        log(f"B={B}: tracking...")
        t0 = time.time()
        if subprocess.run(base + ["--phase", "track"]).returncode != 0:
            raise SystemExit(f"track failed at B={B}")
        track_s = time.time() - t0
        log(f"B={B}: evaluating...")
        if subprocess.run(base + ["--phase", "eval"]).returncode != 0:
            raise SystemExit(f"eval failed at B={B}")
        with open(res_json) as f:
            ev = json.load(f)
        # frames/s from the track's own summary; None without one
        psuf = "" if args.net_preset == "tiny" else f"_{args.net_preset}"
        recon_dir = osp.join(args.out, f"recon{psuf}_{tag}", "recon_fixture")
        fps = None
        for fn in sorted(os.listdir(recon_dir)):
            if fn.endswith("_track.json"):
                with open(osp.join(recon_dir, fn)) as f:
                    fps = json.load(f).get("fps")
        w1 = ev["W1_chore_protocol"]
        report["ladder"][key] = dict(
            smpl_v2v_cm=w1["smpl_v2v"]["mean"],
            obj_v2v_cm=w1["obj_v2v"]["mean"],
            smpl_chamf_cm=w1["smpl_chamf"]["mean"],
            obj_chamf_cm=w1["obj_chamf"]["mean"],
            fps_tracked=fps, track_wall_s=track_s)
        log(f"B={B}: {json.dumps(report['ladder'][key])}")
        os.makedirs(osp.dirname(args.results) or ".", exist_ok=True)
        with open(args.results, "w") as f:
            json.dump(report, f, indent=2)
    log(f"wrote {args.results}")
    return report


if __name__ == "__main__":
    main()
