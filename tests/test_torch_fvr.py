"""The port's free-viewpoint rendering (`python3 -m
nonrigid_nerf_torch.cli.free_viewpoint_rendering`) held against the JAX
package's root free_viewpoint_rendering.py, both on one tiny experiment
that the port's training CLI wrote: every camera path and every scene edit,
the deformation subsets, --view_stride and --export_ray_bending_objs.
RGB, disparity, rigidity and error-map PNGs within one uint8 step;
correspondences within one step on at least 99% of the pixels (the
100-voxel wrap turns a last-bit difference into a full step); scores.json
PSNR to 1e-3 dB and SSIM to 1e-5; background_stability.json to 1e-5. Also
`_surface_post` against JAX's on one detailed dict, exactly; the int8 path
(the port runs `mlp_i8_plain` on the CPU, JAX leaves int8 to a TPU) against
the port's f32 path at 30 dB; and the trained `results/r3_eval` checkpoint
rendered by both packages at render_factor 8 (48 x 64), RGB to 1e-4."""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

import free_viewpoint_rendering as j_fvr
import tests.test_cli as jax_cli_tests
from nonrigid_nerf_torch.cli import free_viewpoint_rendering as t_fvr
from nonrigid_nerf_torch.checkpoints import read_checkpoint, write_checkpoint
from nonrigid_nerf_torch.cli import train as t_train_cli
from nonrigid_nerf_torch.utils.image_io import imread
from tests.test_data import write_synthetic_sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R3_EVAL = os.path.join(REPO, "results", "r3_eval", "pretrained", "logs")


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """The JAX CLI tests' tiny scene (4 frames of 32 x 36), trained 8 steps
    by the port's CLI, with a test split (frame 3)."""
    root = tmp_path_factory.mktemp("fvr")
    datadir = root / "data"
    datadir.mkdir()
    write_synthetic_sequence(str(datadir), n=4, H=32, W=36)
    cfg_path = root / "tiny.txt"
    cfg_path.write_text(jax_cli_tests.TINY_CONFIG.format(
        datadir=datadir, rootdir=root / "experiments"))
    t_train_cli.main(["--config", str(cfg_path), "--device", "cpu",
                      "--train_block_size", "3", "--test_block_size", "1"])
    return str(root / "experiments" / "tiny_exp")


def render_port(exp, flags):
    return t_fvr.free_viewpoint_rendering(t_fvr.build_parser().parse_args(
        ["--input", exp, "--device", "cpu"] + flags))


def render_both(experiment, tmp_path, flags):
    """Both CLIs on copies of the experiment; their output folders."""
    outs = []
    for name, cli, extra in (("jax", j_fvr, []),
                             ("port", t_fvr, ["--device", "cpu"])):
        exp = str(tmp_path / name)
        shutil.copytree(experiment, exp)
        outs.append(cli.free_viewpoint_rendering(cli.build_parser().parse_args(
            ["--input", exp] + flags + extra)))
    return outs


def files(folder, pattern):
    return sorted(os.path.relpath(p, folder) for p in
                  glob.glob(os.path.join(folder, "**", pattern),
                            recursive=True))


def assert_same_outputs(want, got):
    assert os.path.basename(want) == os.path.basename(got)
    pngs = files(want, "*.png")
    assert pngs and pngs == files(got, "*.png")
    assert files(want, "*.obj") == files(got, "*.obj")
    for name in pngs:
        a = imread(os.path.join(want, name)).astype(int)
        b = imread(os.path.join(got, name)).astype(int)
        assert a.shape == b.shape, name
        diff = np.abs(a - b)
        if os.path.basename(name).startswith("correspondences"):
            assert np.mean(diff.max(-1) <= 1) >= 0.99, name
        else:
            assert diff.max() <= 1, name
    for name in files(want, "*.obj"):
        a = np.loadtxt(os.path.join(want, name), usecols=(1, 2, 3))
        b = np.loadtxt(os.path.join(got, name), usecols=(1, 2, 3))
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=name)
    scores = os.path.join(want, "scores.json")
    assert os.path.exists(scores) == \
        os.path.exists(os.path.join(got, "scores.json"))
    if os.path.exists(scores):
        a = json.load(open(scores))
        b = json.load(open(os.path.join(got, "scores.json")))
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], dict):
                assert b[k]["psnr"] == pytest.approx(a[k]["psnr"], abs=1e-3)
                assert b[k]["ssim"] == pytest.approx(a[k]["ssim"], abs=1e-5)
                assert a[k]["lpips"] is None and b[k]["lpips"] is None
        assert b["average_psnr"] == pytest.approx(a["average_psnr"], abs=1e-3)
        assert b["average_ssim"] == pytest.approx(a["average_ssim"], abs=1e-5)
        assert a["average_lpips"] is None and b["average_lpips"] is None
        assert a["lpips_available"] is b["lpips_available"] is False
    stability = os.path.join(want, "background_stability.json")
    assert os.path.exists(stability) == \
        os.path.exists(os.path.join(got, "background_stability.json"))
    if os.path.exists(stability):
        a = json.load(open(stability))
        b = json.load(open(os.path.join(got, "background_stability.json")))
        assert set(a) == set(b)
        for k in a:
            assert b[k] == pytest.approx(a[k], abs=1e-5), k


CASES = {
    # every camera path
    "input_reconstruction": ["--deformations", "train",
                             "--camera_path", "input_reconstruction"],
    "test_subset": ["--deformations", "test",
                    "--camera_path", "input_reconstruction"],
    "fixed": ["--deformations", "all", "--camera_path", "fixed",
              "--fixed_view", "1"],
    "spiral": ["--deformations", "train", "--camera_path", "spiral"],
    "adaptive_spiral": ["--deformations", "all",
                        "--camera_path", "adaptive_spiral"],
    "time_interpolation": ["--deformations", "all",
                           "--camera_path", "time_interpolation",
                           "--num_target_frames", "5", "--fixed_view", "2"],
    # every edit
    "background_stabilization": ["--deformations", "all",
                                 "--camera_path", "fixed",
                                 "--forced_background_stabilization", "0.5"],
    "motion_factor": ["--deformations", "train",
                      "--camera_path", "input_reconstruction",
                      "--motion_factor", "2"],
    "foreground_removal": ["--deformations", "all",
                           "--camera_path", "input_reconstruction",
                           "--foreground_removal", "0.5"],
    "canonical": ["--deformations", "train", "--camera_path", "spiral",
                  "--render_canonical"],
    # the subsampled protocol and the ray-bending meshes
    "stride_and_objs": ["--deformations", "all",
                        "--camera_path", "input_reconstruction",
                        "--view_stride", "2", "--export_ray_bending_objs"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fvr_matches_jax(experiment, tmp_path, case):
    want, got = render_both(experiment, tmp_path, CASES[case])
    assert_same_outputs(want, got)
    if case == "stride_and_objs":
        assert os.path.basename(got) == "all_input_reconstruction_stride2"
        assert len(files(got, "rgb_*.png")) == 2
        assert len(files(got, "ray_bending_*_deltas.obj")) == 2
    if case in ("fixed", "background_stabilization"):
        assert os.path.exists(os.path.join(got, "standard_deviations.png"))


def test_surface_post_equals_jax():
    import jax.numpy as jnp
    rng = np.random.RandomState(0)
    r, s = 37, 12
    w = rng.rand(r, s).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    out = {"rgb_map": rng.rand(r, 3).astype(np.float32),
           "disp_map": rng.rand(r).astype(np.float32),
           "visibility_weights": rng.rand(r, 6).astype(np.float32),
           "input_pts": rng.randn(r, 6, 3).astype(np.float32),
           "fine_visibility_weights": w,
           "fine_input_pts": rng.randn(r, s, 3).astype(np.float32),
           "fine_rigidity_mask": rng.rand(r, s, 1).astype(np.float32)}
    for keys in (out, {k: v for k, v in out.items()
                       if not k.startswith("fine_")}):
        want = j_fvr._surface_post({k: jnp.asarray(v) for k, v in keys.items()})
        got = t_fvr._surface_post({k: torch.from_numpy(v)
                                   for k, v in keys.items()})
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_device_defaults_to_cuda(experiment, tmp_path, monkeypatch):
    """Without --device the CLI asks for cuda: on a box without a GPU it
    raises before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = str(tmp_path / "exp")
    shutil.copytree(experiment, exp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_fvr.main(["--input", exp, "--deformations", "train",
                    "--camera_path", "fixed"])
    assert not os.path.exists(os.path.join(exp, "output"))


@pytest.fixture(scope="module")
def flagship_experiment(tmp_path_factory):
    """An experiment of the flagship's canonical MLP (8 x 256, the skip at
    4, 10 octaves), which the int8 kernel covers, on the tiny scene: 2
    steps of the port's CLI."""
    root = tmp_path_factory.mktemp("fvr_flagship")
    datadir = root / "data"
    datadir.mkdir()
    write_synthetic_sequence(str(datadir), n=4, H=24, W=28)
    t_train_cli.main([
        "--datadir", str(datadir), "--rootdir", str(root / "experiments"),
        "--expname", "flagship", "--ray_bending", "simple_neural",
        "--factor", "1", "--N_samples", "8", "--N_importance", "8",
        "--N_rand", "64", "--N_iters", "2", "--i_weights", "2",
        "--i_img", "0", "--i_video", "1000", "--i_testset", "1000",
        "--seed", "0", "--device", "cpu"])
    # two steps leave the density head of a 256-wide init below zero
    # everywhere (black frames) and its colours flat: raise the density's
    # bias, as the JAX tests of the kernel do, and scale the head up, so
    # that the frames show a scene
    path = str(root / "experiments" / "flagship" / "logs" / "latest.npz")
    step, params, extras = read_checkpoint(path)
    for net in ("coarse", "fine"):
        params[net]["output"]["w"] *= 10.0
        params[net]["output"]["b"][3] += 1.0
    write_checkpoint(path, step, params, None, extras)
    return str(root / "experiments" / "flagship")


def test_quantize_inference_against_the_f32_path(flagship_experiment):
    from nonrigid_nerf_torch.utils.metrics import psnr
    flags = ["--deformations", "train", "--camera_path", "input_reconstruction"]
    off = render_port(flagship_experiment, flags)
    int8 = render_port(flagship_experiment, flags + ["--quantize_inference"])
    assert os.path.basename(int8) == "train_input_reconstruction_int8"
    frames = files(off, "rgb_*.png")
    assert len(frames) == 4 and frames == files(int8, "rgb_*.png")
    for name in frames:
        a = imread(os.path.join(off, name)) / 255.0
        b = imread(os.path.join(int8, name)) / 255.0
        assert a.std() > 0.01       # not a flat frame
        assert psnr(a, b) >= 30.0, name
    assert json.load(open(os.path.join(int8, "scores.json")))[
        "average_psnr"] == pytest.approx(json.load(open(os.path.join(
            off, "scores.json")))["average_psnr"], abs=0.5)
    # a scene edit turns the int8 kernel off: the folder says so
    edited = render_port(flagship_experiment, flags + [
        "--quantize_inference", "--motion_factor", "2"])
    assert os.path.basename(edited) == \
        "train_input_reconstruction_exaggeration_2.0"


def test_r3_eval_checkpoint_renders_as_in_jax():
    """The trained flagship checkpoint (200,000 JAX steps on the example
    sequence, whose images are not in the repository) from a look-at pose
    inside its volume, by both packages at render_factor 8."""
    from chip_smoke import look_at_poses     # phase 7's poses
    from nonrigid_nerf_torch.apps.render_path import render_path
    from nonrigid_nerf_torch.checkpoints import load_checkpoint
    from nonrigid_nerf_torch.config import (load_args, model_config_from_args,
                                            render_settings_from_args)
    from nonrigid_nerf_tpu.apps.render_path import render_path as j_render
    from nonrigid_nerf_tpu.checkpoints import load_checkpoint as j_load
    from nonrigid_nerf_tpu.config import load_args as j_load_args
    from nonrigid_nerf_tpu.config import model_config_from_args as j_cfg_of
    from nonrigid_nerf_tpu.config import render_settings_from_args as j_rs_of

    args = load_args(os.path.join(R3_EVAL, "args.txt"))
    cfg = model_config_from_args(args)
    step, model, extras = load_checkpoint(
        os.path.join(R3_EVAL, "latest.npz"), cfg, device="cpu")
    assert step == 200000
    assert sum(p.numel() for p in model.parameters()) == 1007627
    scripts = extras["scripts_dict"]
    rs = render_settings_from_args(args, scripts["near"], scripts["far"])
    poses = look_at_poses(scripts, n=1)
    intr = [extras["intrinsics"]["0"]]
    latents = model.latents.detach().numpy()[[43]]
    # one block of the frame's 48 x 64 rays (the default chunk would pad
    # them to 32,768)
    rgb, disp = render_path(model, cfg, rs, poses, intr, latents, chunk=3072,
                            render_factor=8, verbose=False, device="cpu")

    j_args = j_load_args(os.path.join(R3_EVAL, "args.txt"))
    _, j_params, _, _ = j_load(os.path.join(R3_EVAL, "latest.npz"))
    j_rgb, j_disp = j_render(j_params, j_cfg_of(j_args),
                             j_rs_of(j_args, scripts["near"], scripts["far"]),
                             poses, intr, latents, chunk=3072,
                             render_factor=8, verbose=False)
    assert rgb.shape == (1, 48, 64, 3)
    assert rgb.std() > 0.05         # a scene, not a flat frame
    np.testing.assert_allclose(rgb, np.asarray(j_rgb), rtol=0, atol=1e-4)
    # disparity is 1 / depth: a depth's last bits move it most (measured:
    # 1 of 3,072 pixels 5e-4 apart in relative terms)
    np.testing.assert_allclose(disp, np.asarray(j_disp), rtol=1e-3, atol=0)


def test_setup_namespace_renders_as_in_jax(experiment):
    """`setup()`: the JAX CLI's namespace, and its `render` (with an edit)
    equal to JAX's."""
    from nonrigid_nerf_torch.config import EditConfig
    from nonrigid_nerf_tpu.config import EditConfig as JEditConfig
    ours = t_fvr.setup(experiment, device="cpu")
    theirs = j_fvr.setup(experiment)
    assert set(vars(theirs)) <= set(vars(ours))
    np.testing.assert_array_equal(ours.frame_latents, theirs.frame_latents)
    np.testing.assert_array_equal(ours.latents, np.asarray(theirs.latents))
    for edit, j_edit in ((None, None),
                         (EditConfig(test_time_scaling=2.0),
                          JEditConfig(test_time_scaling=2.0))):
        rgb, disp = ours.render(ours.poses[1:3], ours.frame_latents[1:3],
                                edit=edit)
        j_rgb, j_disp = theirs.render(theirs.poses[1:3],
                                      theirs.frame_latents[1:3], edit=j_edit)
        np.testing.assert_allclose(rgb, np.asarray(j_rgb), rtol=0, atol=1e-4)
        np.testing.assert_allclose(disp, np.asarray(j_disp), rtol=1e-3,
                                   atol=0)


# planted at the end of the snapshot's CLI module: its `main` leaves a mark
# in the experiment folder before it renders
SNAPSHOT_MARKER = '''

_snapshot_main = main


def main(argv=None):
    exp = argv[argv.index("--input") + 1]
    with open(os.path.join(exp, "snapshot_marker.txt"), "w") as f:
        f.write(os.path.abspath(__file__))
    return _snapshot_main(argv)
'''


@pytest.mark.parametrize("with_backup", [True, False])
def test_renders_with_the_experiment_snapshot(experiment, tmp_path,
                                             monkeypatch, with_backup):
    """With backup/nonrigid_nerf_torch the CLI hands the render to the
    snapshot's code (a child process; the planted mark shows whose code
    ran), and returns its exit code; without backup/ the checkout's code
    renders in this process."""
    exp = str(tmp_path / "exp")
    shutil.copytree(experiment, exp)
    snapshot_cli = os.path.join(exp, "backup", "nonrigid_nerf_torch", "cli",
                                "free_viewpoint_rendering.py")
    assert os.path.exists(snapshot_cli)     # the training CLI's snapshot
    if with_backup:
        with open(snapshot_cli, "a") as f:
            f.write(SNAPSHOT_MARKER)
    else:
        shutil.rmtree(os.path.join(exp, "backup"))
    in_process = []
    real = t_fvr.free_viewpoint_rendering
    monkeypatch.setattr(t_fvr, "free_viewpoint_rendering",
                        lambda a: in_process.append(a) or real(a))
    monkeypatch.delenv(t_fvr.SNAPSHOT_ENV, raising=False)
    # one intra-op thread here and in the child: the suite runs several
    # workers on the same cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["--input", exp, "--deformations", "train", "--camera_path",
            "input_reconstruction", "--view_stride", "2", "--device", "cpu"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert t_fvr.main(argv) == 0
    finally:
        torch.set_num_threads(threads)
    marker = os.path.join(exp, "snapshot_marker.txt")
    output = os.path.join(exp, "output", "train_input_reconstruction_stride2")
    assert len(files(output, "rgb_*.png")) == 2
    if with_backup:
        assert not in_process
        with open(marker) as f:
            assert f.read() == os.path.realpath(snapshot_cli)
    else:
        assert len(in_process) == 1 and not os.path.exists(marker)
    # the child carries the marker and does not hand on again
    assert t_fvr.snapshot_dir(exp) == (
        os.path.join(os.path.abspath(exp), "backup") if with_backup else None)
    monkeypatch.setenv(t_fvr.SNAPSHOT_ENV, "1")
    assert t_fvr.snapshot_dir(exp) is None
