"""Convert the JAX trainer's orbax checkpoints into the torch layout the
PyTorch port reads.

    python scripts/orbax_to_torch.py --kind sifnet --preset tiny \
        --exp experiments/sifnet --out experiments/sifnet_torch
    python scripts/orbax_to_torch.py --kind smoothnet-smpl \
        --exp experiments/smoothnet --out experiments/smoothnet_torch
    python scripts/orbax_to_torch.py --kind infiller \
        --exp experiments/infiller --out experiments/infiller_torch

It runs where orbax and flax are installed (the port itself imports
neither). It restores the newest checkpoint of the experiment folder,
as the JAX `track` does (vistracker_tpu/fit/trainer_loop.py:CheckpointIO.
restore_latest, template-free through numpy), carries its parameters
through the port's converters (vistracker_tpu_torch/models/weights.py)
into the module the port's `track` builds for that kind, and writes the
reference's torch layout, which the port's find_checkpoint selects:

    <out>/checkpoints/checkpoint_0h:0m:0s_0.0.tar
        {model_state_dict, step}   (orbax records no training time)
    <out>/best_model.json          {step, val_loss, ck_file}

Then `track --sifnet-ckpt <out>` (or --infiller-ckpt,
--smoothnet-smpl-ckpt, --smoothnet-objrot-ckpt) loads it. The kind of
network is a flag; it is never guessed from the shapes. Prints one JSON
line: the kind, the step, the number of tensors and the file written.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

KINDS = ("sifnet", "smoothnet-smpl", "smoothnet-objrot", "infiller")


def restore_newest(exp: str):
    """(params as a numpy tree, step) of the newest orbax checkpoint
    under exp, as the JAX `track` restores it."""
    from vistracker_tpu.fit.trainer_loop import CheckpointIO

    if not os.path.isdir(os.path.join(exp, "checkpoints")):
        raise SystemExit(f"no orbax checkpoints/ folder under {exp}")
    state, step = CheckpointIO(exp).restore_latest(None)
    if state is None:
        raise SystemExit(f"no orbax checkpoint found under {exp}")
    return (state["params"] if "params" in state else state), int(step)


def port_module(args):
    """The port's module that `track` builds for this kind, and the
    converter of the flax params into its state_dict."""
    from vistracker_tpu_torch.cli.real_track import SMOOTH_WINDOW
    from vistracker_tpu_torch.models import weights
    from vistracker_tpu_torch.models.infiller import (ConditionalMInfiller,
                                                      InfillerConfig)
    from vistracker_tpu_torch.models.sifnet import SIFNet, sifnet_preset
    from vistracker_tpu_torch.models.smoothnet import SmoothNet, SmoothNetSMPL

    if args.kind == "sifnet":
        cfg = dataclasses.replace(sifnet_preset(args.preset),
                                  variant=args.variant)
        return SIFNet(cfg), lambda p: weights.sifnet_state_dict_from_flax(
            p, cfg)
    if args.kind == "infiller":
        return (ConditionalMInfiller(InfillerConfig()),
                weights.infiller_state_dict_from_flax)
    smpl = args.kind == "smoothnet-smpl"
    net = (SmoothNetSMPL if smpl else SmoothNet)(window_size=SMOOTH_WINDOW,
                                                 output_size=SMOOTH_WINDOW)
    return net, lambda p: weights.smoothnet_state_dict_from_flax(p, smpl)


def write_torch_checkpoint(out: str, state_dict: dict, step: int,
                           val_loss: float) -> str:
    import torch

    ck_dir = os.path.join(out, "checkpoints")
    os.makedirs(ck_dir, exist_ok=True)
    name = "checkpoint_0h:0m:0s_0.0.tar"
    path = os.path.join(ck_dir, name)
    torch.save({"model_state_dict": state_dict, "step": step}, path)
    with open(os.path.join(out, "best_model.json"), "w") as f:
        json.dump({"step": step, "val_loss": val_loss, "ck_file": name}, f)
    return path


def jax_val_loss(exp: str, step: int) -> float:
    """The JAX run's best validation loss if its best step is this one,
    else inf (so a port run resumed in <out> records its own best)."""
    path = os.path.join(exp, "best_model.json")
    if os.path.isfile(path):
        with open(path) as f:
            best = json.load(f)
        if int(best.get("step", -1)) == step:
            return float(best["val_loss"])
    return float("inf")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--exp", required=True,
                    help="the JAX trainer's experiment folder (holds "
                         "checkpoints/<step>/)")
    ap.add_argument("--out", required=True,
                    help="folder for the torch checkpoint (not --exp)")
    ap.add_argument("--kind", required=True, choices=KINDS)
    ap.add_argument("--preset", choices=("tiny", "small", "release"),
                    default="release", help="SIF-Net size (--kind sifnet)")
    ap.add_argument("--variant", default="chore-triplane-vis",
                    choices=("chore", "chore-triplane", "chore-triplane-vis"),
                    help="SIF-Net variant (--kind sifnet)")
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) == os.path.abspath(args.exp):
        raise SystemExit("--out must differ from --exp")

    params, step = restore_newest(args.exp)
    model, convert = port_module(args)
    try:
        state_dict = convert(params)
        model.load_state_dict(state_dict)
    except (KeyError, ValueError, RuntimeError) as e:
        raise SystemExit(f"the checkpoint under {args.exp} does not fit the "
                         f"port's {args.kind} module for these flags: "
                         f"{e!r}")
    path = write_torch_checkpoint(args.out, state_dict, step,
                                  jax_val_loss(args.exp, step))
    result = {"kind": args.kind, "step": step, "tensors": len(state_dict),
              "out": path}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
