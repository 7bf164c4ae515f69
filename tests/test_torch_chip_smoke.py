"""chip_smoke.py's kernel phases rehearsed on the CPU at small sizes: the
card's synchronize and the three timers are patched out, so every wrapper
runs its plain version and each phase's checks (bit-equality, the K2
tolerance, run-to-run equality, the adversarial K3 rows, the all-dead K2
case) and its record run end to end."""
from unittest import mock

import pytest
import torch

import chip_smoke

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

RECORD_KEYS = {"name", "route", "source", "replaces", "max_abs_err", "ms",
               "plain_ms", "bound_ms", "bound_by", "library_ms"}


@pytest.fixture
def no_card():
    with mock.patch.object(torch.cuda, "synchronize", lambda *a: None), \
            mock.patch.object(chip_smoke, "cuda_ms", lambda fn, reps: 0.0), \
            mock.patch.object(chip_smoke, "host_ms", lambda fn: 0.0), \
            mock.patch.object(chip_smoke, "graph_ms", lambda fn, reps: 0.0):
        yield


def test_check_k3_on_the_cpu(no_card, capsys):
    rec = chip_smoke.check_k3(torch.device("cpu"), B=2, N=300, M=200)
    assert set(rec) == RECORD_KEYS and rec["name"] == "label_nn"
    assert rec["max_abs_err"] == 0.0 and rec["bound_ms"] > 0
    out = capsys.readouterr().out
    assert "K3 stage 6" in out and "K3 dense" in out
    assert "K3 main-path density" in out
    # the dense case pairs everything: 2 directions x 2 x 300 x 200
    assert "compatible pairs 240000 of 240000" in out


def test_check_sil_on_the_cpu(no_card, capsys):
    seen = []

    def spy(ops, nbt):
        seen.append(real(ops, nbt)["bound_ms"])
        return real(ops, nbt)

    real = chip_smoke.bound
    with mock.patch.object(chip_smoke, "bound", spy):
        fwd, bwd = chip_smoke.check_sil(torch.device("cpu"), views=2,
                                        size=64)
    assert set(fwd) == set(bwd) == RECORD_KEYS
    assert (fwd["name"], bwd["name"]) == ("max_logit_fwd_soft",
                                          "max_logit_bwd")
    assert fwd["max_abs_err"] == 0.0 and bwd["bound_ms"] > 0
    # K1 soft's and K2's records count what the inputs need: below the
    # all-faces bound over the same live cells, the largest bound the
    # phase computes, printed beside them
    assert 0 < fwd["bound_ms"] < max(seen) and bwd["bound_ms"] < max(seen)
    assert capsys.readouterr().out.count("all-faces bound") == 2


def test_k2_walk_share_counts_the_walked_pairs():
    """k2_walk_share's counts on a small scene: every walked triple is a
    tested one, and a walked triple covers 16 (pixel, face) pairs."""
    import numpy as np
    from vistracker_tpu_torch.ops import coverage as cov

    rng = np.random.RandomState(0)
    ov, of = chip_smoke.object_mesh(12, 10)
    v2d = torch.as_tensor(ov[None, :, :2] / 0.15 * 0.7
                          + 0.05 * rng.randn(2, 1, 2), dtype=torch.float32)
    cpl = cov._planes(v2d, torch.as_tensor(of))
    active = cov._strip_active(cpl, 64, 1.0 / 128.0)
    m, _ = cov.max_logit_fwd(cpl, active, 64)
    walk = chip_smoke.k2_walk_share(cpl, active, m, 64)
    assert 0 < walk["walked"] < walk["triples"]
    assert walk["walked_pixel_faces"] == 16 * walk["walked"]
    assert walk["share"] == walk["walked"] / walk["triples"]


def test_compatible_pairs_counts_the_plan():
    """The compatible pairs are the plan's ranges where it sorts, and
    still the label-sharing valid pairs where a wide label span leaves
    the plan in index order (every range all of y)."""
    from vistracker_tpu_torch.ops.label_nn import label_nn_plan
    lx = torch.tensor([[0, 1, 1, 2]])
    ly = torch.tensor([[1, 0, 1, 1, 5]])
    valid = torch.tensor([[True, True, False, True, True]])
    # x label 0: 1 valid y; label 1: 2 each (twice); label 2: none
    plan = label_nn_plan(lx, ly, valid)
    assert chip_smoke.compatible_pairs(lx, ly, valid) == 5
    assert int((plan.hi - plan.lo).sum()) == 5
    wide = ly * 100  # labels 0..500: index order, ranges of 5
    plan = label_nn_plan(lx * 100, wide, valid)
    assert int((plan.hi - plan.lo).sum()) == 20
    assert chip_smoke.compatible_pairs(lx * 100, wide, valid) == 5


def test_check_k1_on_the_cpu(no_card, capsys):
    """check_k1 at 64 px on one frame of a small sphere: its edge cases
    (every cell dead, one view, faces repeated in a second block), skip
    counts and live-block distribution run end to end."""
    rec = chip_smoke.check_k1(torch.device("cpu"), frames=1, size=64,
                              small=(32,), mesh=(12, 10))
    assert set(rec) == RECORD_KEYS and rec["name"] == "max_logit_fwd"
    assert rec["max_abs_err"] == 0.0 and rec["bound_ms"] > 0
    out = capsys.readouterr().out
    assert "skip test walked" in out and "live face blocks" in out
    assert "all-faces bound" in out
    assert "cnt doubled" in out


def test_live_distribution_counts_blocks_per_row():
    """Live face blocks per (view, strip, x tile): at 512 px a row of the
    liveness holds 4 x tiles of 3 face blocks each."""
    active = torch.zeros((2, 4 * 3), dtype=torch.int32)
    active[0, :3] = 1          # x tile 0 of row 0: 3 live blocks
    active[1, 3 * 3 + 1] = 1   # x tile 3 of row 1: 1
    d = chip_smoke.live_distribution(active, size=512, n_faces_padded=384)
    assert d == {"max": 3, "mean": 0.5, "none": 6 / 8}


def test_check_k4_on_the_cpu(no_card, capsys):
    """check_k4 at 300 x 200 points: the tie cases (y of copies), the
    all-masked row, one point, fewer y points than a split and the
    two-run check run end to end."""
    rec = chip_smoke.check_k4(torch.device("cpu"), N=300, M=200)
    assert set(rec) == RECORD_KEYS and rec["name"] == "nn_min_sqdist"
    assert rec["max_abs_err"] == 0.0
    out = capsys.readouterr().out
    assert "copies" in out and "5 y points" in out
    assert "K4 splits of y" in out


def test_synthetic_phase_on_the_cpu(capsys):
    """chip_smoke's `track --synthetic` phase with the device pinned to the
    CPU: the run, its v2v checks and its print; the CPU path launches no
    kernel, so the launch check is handed the counts and must see every
    kernel's name."""
    import vistracker_tpu_torch.cli.real_track as rt
    seen = {}
    with mock.patch.object(rt, "resolve_device",
                           lambda name: torch.device("cpu")), \
            mock.patch.object(chip_smoke, "check_launched",
                              lambda label, launches, names:
                              seen.update(launches)):
        launches = chip_smoke.run_synthetic_path()
    assert set(seen) == set(launches) == {
        "max_logit_fwd", "max_logit_fwd_soft", "max_logit_bwd", "label_nn",
        "nn_min_sqdist"}
    assert "track --synthetic --render (8 frames, the JAX defaults)" \
        in capsys.readouterr().out


def _counting(fn):
    """A wrapper that counts its calls as a kernel wrapper counts its
    launches (the CPU path launches nothing)."""
    def wrapped(*a, **k):
        wrapped.launches += 1
        return fn(*a, **k)
    wrapped.launches = 0
    return wrapped


def test_training_release_phase_on_the_cpu(capsys):
    """T1's steps, checks and record at tiny width (remat on and off)."""
    res = chip_smoke.check_training_release(B=2, N=200, S=32, device="cpu",
                                            preset="tiny")
    assert set(res) == {"remat", "no_remat"}
    for r in res.values():
        assert r["B"] == 2 and r["seconds_a_step"] > 0
        assert len(r["losses"]) == 7 and r["losses"][4] < r["losses"][0]
    out = capsys.readouterr().out
    assert "T1 tiny SIF-Net step, remat on" in out
    assert "T1 tiny SIF-Net step, remat off" in out


def test_training_card_vs_cpu_phase_on_the_cpu(capsys):
    chip_smoke.check_training_card_vs_cpu(B=2, N=300, S=32, card="cpu")
    out = capsys.readouterr().out
    assert "parameters outside 1e-5: 0 of" in out and "0 after 3" in out


def test_training_cli_phase_on_the_cpu(tmp_path, capsys):
    """T3 on a 2-frame fixture: boundary-sample, train-sifnet
    --offline-data and --synthetic (K1 counted through a wrapper that
    routes the CPU tensors through a stand-in for its launch, the plain
    version, so that the phase's comparison at that launch runs), the
    trained checkpoint in `track`, and the SmoothNet and HVOP-Net
    trainers (K4 counted through a wrapper, compared at the downstream
    chamfer's inputs)."""
    import functools
    import vistracker_tpu_torch.cli.real_track as rt
    import vistracker_tpu_torch.fit.generator as gen
    import vistracker_tpu_torch.fit.smplt as smplt
    from test_torch_track import GEN_KW, SMALL_FUNNEL
    from vistracker_tpu_torch.data.fixture import generate_fixture_sequence
    from vistracker_tpu_torch.ops import chamfer, coverage

    fx = generate_fixture_sequence(str(tmp_path / "fx"), T=2, raster=64,
                                   device="cpu")
    orig = smplt.SMPLTFitConfig
    with mock.patch.object(rt, "resolve_device",
                           lambda name: torch.device("cpu")), \
            mock.patch.object(chip_smoke, "WORK", str(tmp_path / "work")), \
            mock.patch.object(smplt, "SMPLTFitConfig",
                              lambda *a, **k: orig(global_iters=1,
                                                   max_iters=1)), \
            mock.patch.object(gen, "GeneratorConfig", functools.partial(
                gen.GeneratorConfig, **GEN_KW)), \
            mock.patch.object(gen, "FUNNEL_DEFAULT", SMALL_FUNNEL), \
            mock.patch.object(coverage, "_fwd_launch",
                              lambda cpl, active, size, stats=None:
                              coverage.max_logit_fwd_plain(cpl, active,
                                                           size)), \
            mock.patch.object(coverage, "max_logit_fwd", _counting(
                lambda *a: coverage._fwd_launch(*a))), \
            mock.patch.object(chamfer, "nn_min_sqdist_fwd",
                              _counting(chamfer.nn_min_sqdist_fwd)):
        chip_smoke.run_training_cli(fx, samples=2000, size=64, batch=2,
                                    track_extra=("--net-size", "64"))
    out = capsys.readouterr().out
    for needle in ("T3 boundary-sample --samples 2000 --flip: 2 frames",
                   "T3 train-sifnet --offline-data (chore, 64^2",
                   "T3 train-sifnet --synthetic (the JAX defaults): 8 steps",
                   "weights equal to the checkpoint's",
                   "T3 train-smoothnet --synthetic",
                   "T3 train-infiller --synthetic", "K4 launches 6",
                   "K1 hard at its call: 24 views x 256 faces (padded) x "
                   "32^2, m and cnt bit-equal",
                   "K4 at its downstream chamfer: ",
                   "both directions, min and argmin bit-equal"):
        assert needle in out, needle


def test_gif_frame_counter_on_known_files(tmp_path):
    """gif_frames walks the blocks of the port's GIF (full frames) and of
    PIL's (which may crop a frame to what changed): screen size, one entry
    an image, the loop count (None without a NETSCAPE block)."""
    import numpy as np
    from PIL import Image
    from vistracker_tpu_torch.data.gif import save_gif
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (3, 20, 30, 3)).astype(np.uint8)
    frames[2] = frames[1]
    frames[2, 5:8, 4:9] = 0
    save_gif(frames, str(tmp_path / "port.gif"), 100)
    assert chip_smoke.gif_frames(str(tmp_path / "port.gif")) == (
        (30, 20), [(30, 20)] * 3, 0)
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(tmp_path / "pil.gif", save_all=True, append_images=imgs[1:],
                 duration=100, loop=0)
    screen, images, loop = chip_smoke.gif_frames(str(tmp_path / "pil.gif"))
    assert screen == (30, 20) and loop == 0 and len(images) == 3
    assert all(w <= 30 and h <= 20 for w, h in images)
    Image.fromarray(frames[0]).save(tmp_path / "one.gif")
    assert chip_smoke.gif_frames(str(tmp_path / "one.gif")) == (
        (30, 20), [(30, 20)], None)


def test_render_phase_on_the_cpu(tmp_path, capsys):
    """Phase 16 on a 2-frame CPU fixture at 64 px: the contact pack, the
    `render` run, its GIF and contact-sphere checks, the card-vs-CPU
    frame comparison (here CPU against CPU) and its prints."""
    import numpy as np
    from scipy.spatial.transform import Rotation
    from vistracker_tpu_torch.data.fixture import generate_fixture_sequence
    from vistracker_tpu_torch.data.packed import load_packed, save_packed

    fx = generate_fixture_sequence(str(tmp_path / "fx"), T=2, raster=64,
                                   device="cpu")
    gt = load_packed(fx["gt_pack"])
    rot = Rotation.from_rotvec(np.asarray(gt["obj_angles"])).as_matrix()
    track = str(tmp_path / "track.pkl")
    save_packed(track, {**gt, "obj_angles": rot.transpose(0, 2, 1)
                        .astype(np.float32)})
    with mock.patch.object(chip_smoke, "WORK", str(tmp_path / "work")):
        res = chip_smoke.run_render_path(fx, track, size=64, card="cpu")
    assert res["seconds_per_frame"] > 0 and res["gif_ms_per_frame"] > 0
    out = capsys.readouterr().out
    assert "render (--top --contact-spheres, 2 frames of 64 x 128" in out
    assert "render card vs CPU, one frame" in out
    contact = load_packed(str(tmp_path / "work" / "render"
                              / "gt_in_contact.pkl"))
    assert not np.allclose(contact["obj_trans"], gt["obj_trans"])


def test_term_probe_phase_on_the_cpu(capsys):
    """Phase 17 at 4 frames and 64^2: the probe's inputs (both contact
    masks hold points), both runs, the comparison and its print."""
    secs = chip_smoke.check_term_probe(card="cpu", T=4, size=64)
    assert secs > 0
    out = capsys.readouterr().out
    assert "term_probe (4 frames, 2,500-face object, 4 views at 64^2" in out
    for name in ("contact", "mask", "object", "ocent", "otemp", "ovtemp"):
        assert f"{name} 0.0e+00 / 0.0e+00" in out, name
