"""scripts/orbax_to_torch.py: orbax experiment folders that the JAX
trainer writes (tiny `train-sifnet --synthetic`, `train-smoothnet`,
`train-infiller`) converted into the torch layout the port reads. The
converted files hold exactly the parameters the JAX `track` restores
(read back through the JAX package's own torch importer); the port's
`track` loads them; and `track --neural-only --net-preset tiny` of both
packages agrees on that checkpoint as tests/test_torch_track.py requires
of random weights. The port still refuses the raw orbax folder, naming
the script."""
import functools
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_track import (GEN_KW, REPO, SMALL_FUNNEL, JaxDraws,
                              _fixture)

torch.set_num_threads(1)

KINDS = {"sifnet": ["--preset", "tiny"], "smoothnet-smpl": [],
         "infiller": []}


def _script():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", os.path.join(REPO, "scripts", "orbax_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX trainer's three orbax folders and their conversions:
    {kind: (orbax folder, torch folder, the script's result)}."""
    from vistracker_tpu.cli import main as jcli

    root = tmp_path_factory.mktemp("orbax")
    runs = {
        "sifnet": (jcli.run_train_sifnet, [
            "train-sifnet", "--synthetic", "--cpu", "--frames", "4",
            "--image-size", "32", "--samples", "96", "--batch-size", "2",
            "--epochs", "1"]),
        "smoothnet-smpl": (jcli.run_train_smoothnet, [
            "train-smoothnet", "--synthetic", "--cpu", "--frames", "100",
            "--batch-size", "4", "--epochs", "1"]),
        "infiller": (jcli.run_train_infiller, [
            "train-infiller", "--synthetic", "--cpu", "--frames", "60",
            "--epochs", "1"]),
    }
    script, out = _script(), {}
    for kind, (run, argv) in runs.items():
        exp, conv = str(root / f"jax_{kind}"), str(root / f"torch_{kind}")
        run(jcli.build_parser().parse_args([*argv, "--out", exp]))
        res = script.main(["--kind", kind, *KINDS[kind], "--exp", exp,
                           "--out", conv])
        out[kind] = (exp, conv, res)
    return out


def _jax_restored(exp):
    """The params the JAX `track` restores from an orbax folder
    (vistracker_tpu/cli/real_track.py:_orbax_params)."""
    from vistracker_tpu.fit.trainer_loop import CheckpointIO
    state, step = CheckpointIO(exp).restore_latest(None)
    return (state["params"] if "params" in state else state), step


def _leaves(tree):
    tree = tree.get("params", tree)
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("kind", list(KINDS))
def test_converted_weights_are_what_jax_restores(trained, kind):
    """The torch file, read back into flax by the JAX package's importer
    (models/torch_import.py), equals the orbax params leaf for leaf, bit
    for bit; find_checkpoint selects that file."""
    from vistracker_tpu.models import torch_import as TI
    from vistracker_tpu.models.infiller import InfillerConfig
    from vistracker_tpu.models.sifnet import sifnet_preset
    from vistracker_tpu_torch.models.weights import find_checkpoint

    exp, conv, res = trained[kind]
    params, step = _jax_restored(exp)
    assert res["step"] == step > 0
    assert find_checkpoint(conv) == res["out"]
    back = {"sifnet": lambda p: TI.sifnet_params(p, sifnet_preset("tiny")),
            "smoothnet-smpl": lambda p: TI.smoothnet_params(p, smpl=True),
            "infiller": lambda p: TI.infiller_params(p, InfillerConfig()),
            }[kind](conv)
    want, got = _leaves(params), _leaves(back)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("kind, flag", [
    ("smoothnet-smpl", "smoothnet_smpl_ckpt"),
    ("infiller", "infiller_ckpt")])
def test_port_track_loads_the_converted_nets(trained, kind, flag):
    """cli/real_track.py:_load_net, as `track` calls it, loads the
    converted SmoothNet and HVOP-Net into the modules it builds, equal to
    the file's tensors."""
    from vistracker_tpu_torch.cli import real_track as rt
    from vistracker_tpu_torch.models.infiller import (ConditionalMInfiller,
                                                      InfillerConfig)
    from vistracker_tpu_torch.models.smoothnet import SmoothNetSMPL
    from vistracker_tpu_torch.models.weights import load_checkpoint_state_dict

    _, conv, _ = trained[kind]
    model = (SmoothNetSMPL(window_size=rt.SMOOTH_WINDOW,
                           output_size=rt.SMOOTH_WINDOW)
             if kind.startswith("smoothnet")
             else ConditionalMInfiller(InfillerConfig()))
    net = rt._load_net(model, conv, 0, "cpu",
                       smoothnet=kind.startswith("smoothnet"))
    sd = load_checkpoint_state_dict(conv)
    assert set(sd) == set(net.state_dict())
    for k, v in net.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_neural_only_track_on_the_converted_checkpoint(trained, tmp_path,
                                                       rng, monkeypatch):
    """`track --neural-only --net-preset tiny` of both packages: JAX on
    the orbax folder, the port on its conversion, both with the JAX
    generator's draws. Tolerances as in test_torch_track.py::
    test_neural_only_track_matches_jax: stage-1 parameters and the
    stage-4 outputs within 1e-4."""
    import vistracker_tpu.fit.generator as jgen
    import vistracker_tpu.fit.smplt as jsmplt
    import vistracker_tpu_torch.fit.generator as tgen
    import vistracker_tpu_torch.fit.smplt as tsmplt
    from vistracker_tpu.cli.main import build_parser as jax_parser
    from vistracker_tpu.cli.real_track import run_real_track as jax_track
    from vistracker_tpu.data.packed import load_packed as load_jax
    from vistracker_tpu_torch.cli.main import build_parser
    from vistracker_tpu_torch.cli.real_track import run_real_track
    from vistracker_tpu_torch.data.packed import load_packed

    from vistracker_tpu.cli.synthetic import box_mesh
    from vistracker_tpu.utils.mesh import save_ply

    exp, conv, _ = trained["sifnet"]
    seq, assets, smpl_pkl = _fixture(tmp_path, rng)
    obj_root = tmp_path / "objects"
    (obj_root / "boxsmall").mkdir(parents=True)
    save_ply(str(obj_root / "boxsmall" / "boxsmall.ply"), *box_mesh())
    common = ["--seq", seq, "--smpl-model", smpl_pkl, "--assets", assets,
              "--objects-root", str(obj_root), "--infiller-ckpt", "random",
              "--net-preset", "tiny", "--neural-only", "--chunk-size", "2",
              "--net-size", "32", "--crop-size", "96", "--save-name",
              "neural"]
    for mod in (jsmplt, tsmplt):
        orig = mod.SMPLTFitConfig
        monkeypatch.setattr(mod, "SMPLTFitConfig", functools.partial(
            lambda o, *a, **k: o(global_iters=1, max_iters=2), orig))
    for mod in (jgen, tgen):
        monkeypatch.setattr(mod, "GeneratorConfig", functools.partial(
            mod.GeneratorConfig, **GEN_KW))
        monkeypatch.setattr(mod, "FUNNEL_DEFAULT", SMALL_FUNNEL)
    monkeypatch.setattr(tgen, "TorchDraws", JaxDraws)
    ref = load_jax(jax_track(jax_parser().parse_args(
        ["track", *common, "--sifnet-ckpt", exp, "--out",
         str(tmp_path / "out_jax")])))
    out = load_packed(run_real_track(build_parser().parse_args(
        ["track", *common, "--sifnet-ckpt", conv, "--device", "cpu",
         "--out", str(tmp_path / "out_torch")]))["packed"])
    assert set(out) == set(ref)
    for k in ("poses", "betas", "trans"):
        np.testing.assert_allclose(out[k], ref[k], atol=1e-4, err_msg=k)
    for k in ("neural_pca", "neural_trans", "neural_visibility"):
        assert np.abs(ref[k]).max() > 0.01, k  # surface points were kept
        np.testing.assert_allclose(out[k], ref[k], atol=1e-4, err_msg=k)


@pytest.mark.parametrize("flag, kind", [
    ("--sifnet-ckpt", "sifnet"), ("--infiller-ckpt", "infiller")])
def test_raw_orbax_dir_is_refused_naming_the_script(trained, tmp_path, flag,
                                                    kind):
    from vistracker_tpu_torch.cli.main import main
    cks = {"--sifnet-ckpt": "random", "--infiller-ckpt": "random"}
    cks[flag] = trained[kind][0]
    with pytest.raises(SystemExit) as e:
        main(["track", "--seq", str(tmp_path), "--smpl-model", "x",
              "--objects-root", "x", "--device", "cpu",
              *[v for kv in cks.items() for v in kv]])
    msg = str(e.value)
    assert "scripts/orbax_to_torch.py" in msg and f"--kind {kind}" in msg
    assert trained[kind][0] in msg


def test_converter_refuses_what_it_cannot_convert(trained, tmp_path):
    """No orbax folder, --out equal to --exp, and a kind or preset whose
    module the params do not fit are refused by name."""
    script = _script()
    exp = trained["infiller"][0]
    with pytest.raises(SystemExit, match="no orbax checkpoints/ folder"):
        script.main(["--kind", "infiller", "--exp", str(tmp_path),
                     "--out", str(tmp_path / "o")])
    with pytest.raises(SystemExit, match="--out must differ"):
        script.main(["--kind", "infiller", "--exp", exp, "--out", exp])
    with pytest.raises(SystemExit, match="does not fit"):
        script.main(["--kind", "smoothnet-smpl", "--exp", exp,
                     "--out", str(tmp_path / "wrong_kind")])
    with pytest.raises(SystemExit, match="does not fit"):
        script.main(["--kind", "sifnet", "--preset", "small", "--exp",
                     trained["sifnet"][0], "--out", str(tmp_path / "small")])
