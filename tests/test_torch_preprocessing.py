"""The port's preprocessing (`nonrigid_nerf_torch/preprocessing/`,
`python3 -m nonrigid_nerf_torch.cli.preprocess`) against the JAX package's
(`nonrigid_nerf_tpu/preprocessing/`, the top-level preprocess.py), on the
synthetic COLMAP binary models and images of tests/test_preprocessing.py:
every output bit for bit (the lens calibration to 1e-6 relative: OpenCV's
solver is not bit-equal from call to call). COLMAP and ffmpeg are on neither machine, so
their calls are held up to the subprocess boundary: the same command
lines."""

import json
import os
import subprocess

import numpy as np
import pytest

import nonrigid_nerf_tpu.preprocessing as j_pre
import nonrigid_nerf_tpu.preprocessing.poses as j_poses
import preprocess as j_cli
from nonrigid_nerf_torch import preprocessing as t_pre
from nonrigid_nerf_torch.cli import preprocess as t_cli
from nonrigid_nerf_torch.preprocessing import poses as t_poses
import tests.test_preprocessing as jax_pre_tests
from tests.test_preprocessing import write_synthetic_colmap_model


def test_colmap_readers_and_qvec_match_jax(tmp_path):
    write_synthetic_colmap_model(str(tmp_path))
    for name in ("read_cameras_binary", "read_images_binary",
                 "read_points3d_binary"):
        file = {"read_cameras_binary": "cameras.bin",
                "read_images_binary": "images.bin",
                "read_points3d_binary": "points3D.bin"}[name]
        got = getattr(t_pre, name)(str(tmp_path / file))
        want = getattr(j_pre, name)(str(tmp_path / file))
        assert list(got) == list(want)
        for k in got:
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    q = np.array([0.9, 0.1, -0.3, 0.2])
    np.testing.assert_array_equal(t_pre.qvec2rotmat(q), j_pre.qvec2rotmat(q))


def test_poses_bounds_match_jax(tmp_path):
    for side in ("t", "j"):
        write_synthetic_colmap_model(str(tmp_path / side / "sparse" / "0"),
                                     n_images=5, n_points=80)
    got = t_pre.colmap_to_poses_bounds(str(tmp_path / "t"))
    want = j_pre.colmap_to_poses_bounds(str(tmp_path / "j"))
    assert got.shape == (5, 17)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.load(tmp_path / "t" / "poses_bounds.npy"),
                                  np.load(tmp_path / "j" / "poses_bounds.npy"))


def _recorder(calls):
    def run(cmd, **kwargs):
        calls.append(list(cmd))
        return subprocess.CompletedProcess(cmd, 0)
    return run


def test_colmap_and_ffmpeg_command_lines_match_jax(tmp_path, monkeypatch):
    """gen_poses without a sparse model runs COLMAP's three stages; a video
    input runs ffmpeg twice; the same command lines as the JAX package's,
    and the same missing-binary error."""
    # one subprocess module serves both packages: record the port's calls,
    # then the JAX package's
    calls = []
    monkeypatch.setattr(subprocess, "run", _recorder(calls))
    assert t_poses.subprocess is j_poses.subprocess is subprocess
    for matching in ("sequential_matcher", "exhaustive_matcher"):
        t_pre.run_colmap(str(tmp_path), matching, "/opt/colmap")
    got, calls[:] = list(calls), []
    for matching in ("sequential_matcher", "exhaustive_matcher"):
        j_pre.run_colmap(str(tmp_path), matching, "/opt/colmap")
    assert got == calls and len(got) == 6 and got[1][1] == "sequential_matcher"
    with pytest.raises(ValueError, match="matching"):
        t_pre.run_colmap(str(tmp_path), "vocab_tree_matcher")

    video = tmp_path / "clip.mp4"
    video.write_bytes(b"")
    runs = []
    for cli in (t_cli, j_cli):
        calls.clear()
        args = cli.build_parser().parse_args(
            ["--input", str(video), "--output", str(tmp_path / "out"),
             "--fps", "7", "--ffmpeg_path", "/opt/ffmpeg"])
        cli.video_preprocessing(args)
        runs.append(list(calls))
    assert runs[0] == runs[1] and len(runs[0]) == 2
    assert runs[0][0][0] == "/opt/ffmpeg"
    monkeypatch.undo()
    args = t_cli.build_parser().parse_args(
        ["--input", str(video), "--output", str(tmp_path / "o2"),
         "--ffmpeg_path", str(tmp_path / "no_such_ffmpeg")])
    with pytest.raises(FileNotFoundError, match="ffmpeg"):
        t_cli.video_preprocessing(args)


def test_undistortion_matches_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    indir = tmp_path / "seq"
    (indir / "images").mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(3):
        img = (rng.rand(32, 48, 3) * 255).astype(np.uint8)
        cv2.imwrite(str(indir / "images" / f"{i:03d}.png"), img)
    calib = {"newcameramtx": [[40.0, 0, 24], [0, 40.0, 16], [0, 0, 1]],
             "mtx": [[40.0, 0, 24], [0, 40.0, 16], [0, 0, 1]],
             "dist": [[-0.2, 0.05, 0.001, 0.0, 0.0]],
             "roi": (1, 1, 46, 30)}
    with open(tmp_path / "lens_distortion.json", "w") as f:
        json.dump(calib, f)
    outs = {}
    for name, cli, workers in (("t", t_cli, 2), ("j", j_cli, 1)):
        args = cli.build_parser().parse_args(
            ["--input", str(indir), "--output", str(tmp_path / name),
             "--undistort_with_calibration_file", str(tmp_path)])
        cli.undistort(args, workers=workers)
        outs[name] = tmp_path / name
    for rel in ("images/000.png", "images/002.png", "images_mask/mask.png"):
        a = cv2.imread(str(outs["t"] / rel))
        b = cv2.imread(str(outs["j"] / rel))
        assert a is not None and a.shape[:2] == (30, 46)
        np.testing.assert_array_equal(a, b, err_msg=rel)
    assert (outs["t"] / "undistorted_calibration.txt").read_text() == \
        (outs["j"] / "undistorted_calibration.txt").read_text()


def test_lens_calibration_matches_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    helper = jax_pre_tests.TestLensCalibration()
    indir = tmp_path / "seq"
    (indir / "images").mkdir(parents=True)
    rng = np.random.RandomState(3)
    center = np.array([(helper.BH + 1) / 2.0, (helper.BW + 1) / 2.0])
    for i in range(6):
        rvec = np.array([0.25 * rng.randn(), 0.25 * rng.randn(),
                         0.15 * rng.randn()])
        tvec = np.array([-center[1] + 0.8 * rng.randn(),
                         -center[0] + 0.6 * rng.randn(),
                         13.0 + 1.5 * rng.randn()])
        cv2.imwrite(str(indir / "images" / f"{i:03d}.png"),
                    helper._render_view(cv2, rvec, tvec))
    results = {}
    for name, cli in (("t", t_cli), ("j", j_cli)):
        out = tmp_path / name
        out.mkdir()
        cli.lens_distortion_calibration(cli.build_parser().parse_args(
            ["--input", str(indir), "--output", str(out),
             "--calibrate_lens_distortion", "--checkerboard_height",
             str(helper.BH), "--checkerboard_width", str(helper.BW)]))
        results[name] = json.loads((out / "lens_distortion.json").read_text())
    # the same code on both sides, but OpenCV's solver is not bit-equal from
    # call to call (observed: 1.6e-9 relative at most)
    assert results["t"]["roi"] == results["j"]["roi"]
    for key in ("mtx", "dist", "newcameramtx"):
        np.testing.assert_allclose(results["t"][key], results["j"][key],
                                   rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(np.asarray(results["t"]["mtx"])[0, 0], 600.0,
                               rtol=0.02)


def test_preprocess_cli_writes_jaxs_poses_bounds(tmp_path, capsys):
    """`python3 -m nonrigid_nerf_torch.cli.preprocess --input <folder>` on a
    folder that holds a sparse model: gen_poses skips SfM and converts."""
    for side in ("t", "j"):
        write_synthetic_colmap_model(str(tmp_path / side / "sparse" / "0"))
        (tmp_path / side / "images").mkdir()
    assert t_cli.main(["--input", str(tmp_path / "t")]) == 0
    assert "found existing COLMAP sparse model" in capsys.readouterr().out
    j_cli.preprocess(j_cli.build_parser().parse_args(
        ["--input", str(tmp_path / "j")]))
    np.testing.assert_array_equal(np.load(tmp_path / "t" / "poses_bounds.npy"),
                                  np.load(tmp_path / "j" / "poses_bounds.npy"))
    with pytest.raises(FileNotFoundError, match="does not exist"):
        t_cli.main(["--input", str(tmp_path / "missing")])
    assert os.path.exists(tmp_path / "t" / "poses_bounds.npy")
