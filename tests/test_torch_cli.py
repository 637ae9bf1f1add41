"""The port's training CLI (`nonrigid_nerf_torch/cli/train.py`) on the CPU,
on the JAX CLI tests' tiny scene (tests/test_cli.py): the experiment folder
and its layout, args.txt, checkpoint contents and auto-resume, validation
images, videos and test-set renders, the config surface against the JAX
package's, a SIGKILL-and-resume run bit-equal to an uninterrupted one, and
the JAX package's `load_experiment` reading what the port wrote."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import tests.test_cli as jax_cli_tests
from nonrigid_nerf_torch import config as t_config
from nonrigid_nerf_torch.checkpoints import load_train_state, read_checkpoint
from nonrigid_nerf_torch.cli import train as cli
from nonrigid_nerf_torch.weights import params_to_jax
from nonrigid_nerf_tpu import config as j_config
from tests.test_data import write_synthetic_sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
SMALL = ["--ray_bending", "simple_neural", "--netdepth", "2", "--netwidth",
         "32", "--netdepth_fine", "2", "--netwidth_fine", "32", "--multires",
         "4", "--N_samples", "4", "--N_importance", "4", "--N_rand", "16",
         "--factor", "1", "--seed", "0", "--chunk", "64"]


def run_cli(argv, capsys=None):
    cli.main(argv + CPU)
    return capsys.readouterr().out if capsys is not None else None


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    datadir = root / "data"
    datadir.mkdir()
    write_synthetic_sequence(str(datadir), n=4, H=32, W=36)
    cfg_path = root / "tiny.txt"
    cfg_path.write_text(jax_cli_tests.TINY_CONFIG.format(
        datadir=datadir, rootdir=root / "experiments"))
    args = cli.parse_args(["--config", str(cfg_path)])
    cli.main(["--config", str(cfg_path)] + CPU)
    return root, args, os.path.join(args.rootdir, args.expname)


def small_scene(tmp_path, n=4, H=10, W=12):
    datadir = tmp_path / "data"
    datadir.mkdir()
    write_synthetic_sequence(str(datadir), n=n, H=H, W=W)
    return ["--datadir", str(datadir), "--rootdir", str(tmp_path / "exp")]


class TestExperimentFolder:
    def test_experiment_layout(self, experiment):
        _, args, folder = experiment
        logdir = os.path.join(folder, "logs")
        for name in ("args.txt", "config.txt", "latest.npz", "cameras.obj",
                     "metrics.jsonl"):
            assert os.path.exists(os.path.join(logdir, name)), name
        backup = os.path.join(folder, "backup")
        for rel in (("nonrigid_nerf_torch", "engine", "render.py"),
                    ("nonrigid_nerf_torch", "cli", "train.py"),
                    ("nonrigid_nerf_torch", "ops", "kernels", "csrc",
                     "mlp_sm90.cuh"),
                    ("nonrigid_nerf_torch", "ops", "kernels", "csrc",
                     "mlp_fwd.cu"),
                    ("configs", "default.txt")):
            assert os.path.exists(os.path.join(backup, *rel)), rel
        assert not os.path.exists(os.path.join(backup, "nonrigid_nerf_torch",
                                               "_build"))

    def test_args_txt_roundtrip(self, experiment):
        _, args, folder = experiment
        path = os.path.join(folder, "logs", "args.txt")
        loaded = t_config.Args(**t_config.parse_config_file(path))
        assert loaded.netdepth == 2 and loaded.N_iters == 8
        assert loaded.ray_bending == "simple_neural"
        assert loaded.offsets_loss_weight == 60.0 and loaded.seed == 0
        assert loaded.to_dict() == args.to_dict()
        # the JAX package reads the same values from it
        assert j_config.parse_config_file(path) == \
            t_config.parse_config_file(path)
        assert "device" not in loaded.to_dict()

    def test_checkpoint_contents(self, experiment):
        _, args, folder = experiment
        step, params, extras = read_checkpoint(
            os.path.join(folder, "logs", "latest.npz"))
        assert step == 8
        assert params["latents"].shape == (4, 32)
        assert set(extras) == {"near", "far", "intrinsics", "scripts_dict",
                               "dataset_extras"}
        sd = extras["scripts_dict"]
        assert sd["near"] == extras["near"] > 0 and sd["far"] == extras["far"]
        assert np.all(np.asarray(sd["min_nerf_volume_point"])
                      < np.asarray(sd["max_nerf_volume_point"]))
        assert extras["intrinsics"]["0"]["height"] == 32
        assert extras["dataset_extras"]["imageid_to_timestepid"] == [0, 1, 2, 3]

    def test_auto_resume_is_noop_at_end(self, experiment, capsys):
        _, args, folder = experiment
        cli.main_function(args, device="cpu")
        out = capsys.readouterr().out
        assert "Reloading from" in out
        assert "Begin training at step 8 -> 8" in out
        rows = [json.loads(line) for line in
                open(os.path.join(folder, "logs", "metrics.jsonl"))]
        assert [r["step"] for r in rows] == [4, 8]

    def test_jax_load_experiment_reads_the_port_folder(self, experiment):
        """The JAX package's inference entry opens the port's experiment:
        the same args, the port's parameters bit for bit, scripts_dict
        intact."""
        import free_viewpoint_rendering as fvr
        _, args, folder = experiment
        j_args, j_params, j_extras = fvr.load_experiment(folder)
        assert j_args.netwidth == 32 and j_args.expname == "tiny_exp"
        cfg = t_config.model_config_from_args(args)
        state, extras = load_train_state(
            os.path.join(folder, "logs", "latest.npz"), cfg, device="cpu")
        ours = params_to_jax(state.model)
        assert jax.tree_util.tree_structure(ours) == \
            jax.tree_util.tree_structure(j_params)
        for (path, a), b in zip(
                jax.tree_util.tree_flatten_with_path(ours)[0],
                jax.tree_util.tree_leaves(j_params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=jax.tree_util.keystr(path))
        assert j_extras["scripts_dict"] == extras["scripts_dict"]
        assert set(j_extras["scripts_dict"]) == {
            "near", "far", "min_nerf_volume_point", "max_nerf_volume_point",
            "image_folder"}


def test_summarize_reads_windows_rates_and_peak(tmp_path, capsys):
    from nonrigid_nerf_torch.cli import summarize
    rows = [{"step": 50, "it_per_sec": 10.0, "psnr": 1.0},
            {"step": 100, "it_per_sec": 25.0, "psnr": 2.0},
            {"step": 100, "val_view": 0, "val_psnr": 9.5},
            {"step": 150, "it_per_sec": 50.0, "psnr": 4.0},
            {"step": 150, "peak_device_bytes": 123}]
    path = tmp_path / "metrics.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    summarize.main([str(path), "--window", "60", "150", "--window", "1", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["windows"][0] == {"from": 60, "to": 150, "readings": 2,
                                 "mean_psnr": 3.0}
    assert out["windows"][1]["readings"] == 0
    # 100 steps in 50 / 25 + 50 / 50 = 3 s
    assert out["steps_per_s"] == pytest.approx(100 / 3.0)
    assert out["steps_per_s_from"] == 51 and out["steps"] == 150
    assert out["val_psnr"] == {"100": 9.5} and out["peak_device_bytes"] == 123


def test_chip_quality_bfloat16_variant_runs_the_cli_at_bf16():
    """chip_quality.py's `bfloat16` variant is the training CLI with
    --compute_dtype bfloat16 on the config of the JAX run; `kernels` and
    `off` keep the config's compute dtype."""
    import chip_quality
    argv, expname = chip_quality.train_argv("bfloat16", 3, 4000, [])
    assert expname == "occlusion_bfloat16_seed3"
    args = cli.parse_args(argv)
    cfg = t_config.model_config_from_args(args)
    assert cfg.compute_dtype == "bfloat16" and cfg.fused_kernel == "auto"
    assert args.die_at_step == 4000 and args.i_weights == 2000
    for variant in ("kernels", "off"):
        args = cli.parse_args(chip_quality.train_argv(variant, 0, 4000, [])[0])
        assert args.compute_dtype == "float32"
    assert chip_quality.VARIANTS == ("kernels", "off", "bfloat16")


class TestConfigSurface:
    def test_defaults_equal_jax(self):
        assert set(t_config.DEFAULTS) == set(j_config.DEFAULTS)
        assert t_config.DEFAULTS == j_config.DEFAULTS
        for key in ("_BOOL_KEYS", "_INT_KEYS", "_FLOAT_KEYS"):
            assert getattr(t_config, key) == getattr(j_config, key), key

    def test_args_methods_match_jax(self, tmp_path):
        kw = dict(seed=3, netwidth=64, ray_bending="simple_neural")
        ours, theirs = t_config.Args(**kw), j_config.Args(**kw)
        assert ours.to_dict() == theirs.to_dict()
        assert ours.replace(lrate=1e-3).to_dict() == \
            theirs.replace(lrate=1e-3).to_dict()
        ours.dump(str(tmp_path / "t.txt"))
        theirs.dump(str(tmp_path / "j.txt"))
        assert (tmp_path / "t.txt").read_text() == \
            (tmp_path / "j.txt").read_text()
        assert os.path.abspath(t_config.default_config_path()) == \
            os.path.abspath(j_config.default_config_path())

    def test_parse_args_reads_switches_and_the_default_config(self):
        args = cli.parse_args(["--fused_kernel", "off",
                               "--no_use_rigidity_network",
                               "--bending_width", "128", "--device", "cpu"])
        cfg = t_config.model_config_from_args(args)
        assert cfg.fused_kernel == "off" and cfg.bending_width == 128
        assert cfg.use_rigidity_network is False
        # no --config: configs/default.txt, as the JAX CLI reads it
        assert args.config == t_config.default_config_path()
        assert args.offsets_loss_weight == 600.0
        assert "device" not in args.to_dict()
        import train as jax_train_cli
        j_args = jax_train_cli.parse_args(
            ["--fused_kernel", "off", "--no_use_rigidity_network",
             "--bending_width", "128"])
        assert j_args.to_dict() == args.to_dict()

    def test_seed_minus_one_resolves_to_a_random_seed(self):
        seeds = {t_config.resolve_seed(t_config.Args(seed=-1)).seed
                 for _ in range(8)}
        assert all(s >= 0 for s in seeds) and len(seeds) > 1
        assert t_config.resolve_seed(t_config.Args(seed=7)).seed == 7
        assert t_config.train_config_from_args(t_config.Args(seed=7)).seed == 7

    @pytest.mark.parametrize("key,value,match", [
        ("checkpoint_format", "orbax", "checkpoint_format"),
        ("checkpoint_format", "tar", "checkpoint_format")])
    def test_unsupported_options_raise(self, key, value, match, tmp_path):
        args = cli.parse_args(small_scene(tmp_path) + [f"--{key}", value])
        with pytest.raises(ValueError, match=match):
            cli.main_function(args, device="cpu")
        assert not os.path.exists(tmp_path / "exp")

    @pytest.mark.parametrize("value", [-1, 0, 1])
    def test_plain_step_prefetch_values_pass(self, value):
        cli.check_supported(t_config.Args(sampling_prefetch=value))


class TestRuns:
    def test_sampling_prefetch_runs_presampled_training(self, tmp_path,
                                                        capsys):
        """--sampling_prefetch 3 trains 7 steps presampled (windows at steps
        0, 3 and 6) bit-equal to the plain step: the same metrics.jsonl and
        the same parameters; -1 is the plain step."""
        scene = small_scene(tmp_path)
        common = scene + SMALL + ["--N_iters", "7", "--i_print", "1",
                                  "--i_weights", "100", "--i_video", "100",
                                  "--i_testset", "100", "--i_img", "0"]
        runs = {"plain": "0", "presampled": "3", "auto": "-1"}
        outs = {}
        for name, value in runs.items():
            outs[name] = run_cli(common + ["--expname", name,
                                           "--sampling_prefetch", value],
                                 capsys)
        assert "presampled training: 3 batches per stack pass" \
            in outs["presampled"]
        assert "presampled" not in outs["plain"] + outs["auto"]

        def logged(name):
            logdir = tmp_path / "exp" / name / "logs"
            rows = [json.loads(line)
                    for line in open(logdir / "metrics.jsonl")]
            return ([{k: v for k, v in r.items() if k != "it_per_sec"}
                     for r in rows],
                    read_checkpoint(str(logdir / "latest.npz"))[1])

        plain_rows, plain_params = logged("plain")
        assert [r["step"] for r in plain_rows] == list(range(1, 8))
        for name in ("presampled", "auto"):
            rows, params = logged(name)
            assert rows == plain_rows, name
            for x, y in zip(jax.tree_util.tree_leaves(params),
                            jax.tree_util.tree_leaves(plain_params)):
                np.testing.assert_array_equal(x, y)

    def test_dumped_seed_is_the_seed_that_trained(self, tmp_path, capsys):
        """seed = -1 is resolved before args.txt is written: a run with the
        dumped seed ends bit-equal."""
        scene = small_scene(tmp_path)
        common = scene + SMALL + ["--N_iters", "3", "--i_print", "3",
                                  "--i_weights", "100", "--i_video", "100",
                                  "--i_testset", "100", "--i_img", "0"]
        run_cli(common + ["--expname", "unseeded", "--seed", "-1"])
        logdir = tmp_path / "exp" / "unseeded" / "logs"
        dumped = t_config.parse_config_file(str(logdir / "args.txt"))["seed"]
        assert dumped >= 0
        run_cli(common + ["--expname", "seeded", "--seed", str(dumped)])
        a = read_checkpoint(str(logdir / "latest.npz"))[1]
        b = read_checkpoint(str(tmp_path / "exp" / "seeded" / "logs"
                                / "latest.npz"))[1]
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(x, y)

    def test_i_img_renders_validation_views(self, tmp_path):
        args = small_scene(tmp_path) + SMALL + [
            "--expname", "val", "--N_iters", "4", "--i_print", "4",
            "--i_weights", "99", "--i_video", "999", "--i_testset", "999",
            "--i_img", "2", "--train_block_size", "2", "--test_block_size",
            "1"]
        run_cli(args)
        logdir = tmp_path / "exp" / "val" / "logs"
        for step in (2, 4):
            assert (logdir / "val_images" / f"{step:06d}.png").exists()
        val_lines = [json.loads(line) for line in open(logdir / "metrics.jsonl")
                     if "val_psnr" in line]
        assert [v["step"] for v in val_lines] == [2, 4]
        assert all(np.isfinite(v["val_psnr"]) for v in val_lines)
        # with a test split the held-out view is validated
        assert val_lines[0]["val_view"] == 2
        # the final checkpoint at N_iters whatever i_weights is
        assert read_checkpoint(str(logdir / "latest.npz"))[0] == 4

    def test_i_video_and_i_testset_outputs(self, tmp_path, monkeypatch,
                                           capsys):
        """Every i_video interval writes the four videos, the last one also
        the training set's; every i_testset interval a training subset and
        the test set, with error maps."""
        from nonrigid_nerf_torch.utils import video
        written = []

        def fake_writer(path, frames, fps=30):
            written.append(os.path.basename(path))
            assert np.asarray(frames).dtype == np.uint8
            assert np.asarray(frames).ndim in (3, 4)

        monkeypatch.setattr(video, "mp4_writer", lambda: fake_writer)
        args = small_scene(tmp_path) + SMALL + [
            "--expname", "vid", "--N_iters", "4", "--i_print", "4",
            "--i_weights", "99", "--i_video", "2", "--i_testset", "4",
            "--i_img", "0", "--train_block_size", "2",
            "--test_block_size", "1"]
        run_cli(args)
        kinds = ("rgb.mp4", "disp.mp4", "disp_jet.mp4", "disp_phong.mp4")
        for step in (2, 4):
            for kind in kinds:
                assert f"vid_spiral_{step:06d}_{kind}" in written, written
        for kind in kinds:
            assert f"vid_training_{4:06d}_{kind}" in written, written
        assert not any(n.startswith("vid_training_000002") for n in written)
        logdir = tmp_path / "exp" / "vid" / "logs"
        test_files = set(os.listdir(logdir / "testset_000004"))
        assert {"000.png", "disp_000.png", "disp_jet_000.png",
                "disp_phong_000.png", "error_000.png"} <= test_files
        assert "error_000.png" in os.listdir(logdir / "trainsubset_000004")

        monkeypatch.setattr(video, "mp4_writer", lambda: None)
        cli._write_videos(str(tmp_path / "x_"), np.zeros((2, 3, 4, 3)),
                          np.ones((2, 3, 4)))
        out = capsys.readouterr().out
        assert out.count("videos skipped") == 1

    def test_write_videos_with_opencv(self, tmp_path):
        """The four videos through OpenCV's writer, read back frame by
        frame."""
        cv2 = pytest.importorskip("cv2")
        rng = np.random.RandomState(0)
        cli._write_videos(str(tmp_path / "v_"), rng.rand(3, 16, 24, 3),
                          rng.rand(3, 16, 24) + 0.1)
        for kind in ("rgb", "disp", "disp_jet", "disp_phong"):
            cap = cv2.VideoCapture(str(tmp_path / f"v_{kind}.mp4"))
            frames = []
            ok, frame = cap.read()
            while ok:
                frames.append(frame)
                ok, frame = cap.read()
            cap.release()
            assert len(frames) == 3 and frames[0].shape == (16, 24, 3), kind

    def test_final_checkpoint_and_ft_path(self, tmp_path, capsys):
        """A run saves at its last step whatever i_weights is, and ft_path
        starts another run from that file."""
        scene = small_scene(tmp_path)
        common = scene + SMALL + ["--i_print", "100", "--i_weights", "100",
                                  "--i_video", "100", "--i_testset", "100",
                                  "--i_img", "0"]
        run_cli(common + ["--expname", "a", "--N_iters", "3"])
        ckpt = tmp_path / "exp" / "a" / "logs" / "latest.npz"
        assert read_checkpoint(str(ckpt))[0] == 3
        out = run_cli(common + ["--expname", "b", "--N_iters", "5",
                                "--ft_path", str(ckpt)], capsys)
        assert f"Reloading from {ckpt}" in out
        assert "Begin training at step 3 -> 5" in out
        assert read_checkpoint(str(tmp_path / "exp" / "b" / "logs"
                                   / "latest.npz"))[0] == 5

    def test_no_reload_wipes_the_experiment(self, tmp_path):
        scene = small_scene(tmp_path)
        common = scene + SMALL + ["--expname", "w", "--N_iters", "2",
                                  "--i_print", "100", "--i_img", "0"]
        run_cli(common)
        stale = tmp_path / "exp" / "w" / "stale.txt"
        stale.write_text("x")
        run_cli(common + ["--no_reload"])
        assert not stale.exists()
        assert (tmp_path / "exp" / "w" / "logs" / "latest.npz").exists()


class TestKillAndResume:
    """A run SIGKILLed after its save at step 40 and started again ends as
    an uninterrupted run does: the same metric stream, bit-equal
    parameters and Adam moments. The canonical MLP runs its f32 path on the
    CPU (`auto` off a GPU)."""

    def _launch(self, cfg_path):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        return subprocess.run(
            [sys.executable, "-m", "nonrigid_nerf_torch.cli.train",
             "--config", str(cfg_path), "--device", "cpu"],
            cwd=REPO, env=env, capture_output=True, timeout=420)

    def _metrics(self, rootdir):
        out = {}
        with open(os.path.join(rootdir, "kr", "logs", "metrics.jsonl")) as f:
            for line in f:
                m = json.loads(line)
                if "loss" in m:
                    out[m["step"]] = m
        return out

    def test_sigkill_resume_equals_uninterrupted(self, tmp_path):
        datadir = tmp_path / "data"
        datadir.mkdir()
        write_synthetic_sequence(str(datadir), n=3, H=10, W=12)
        roots = {}
        for run, extra in (("A", ""), ("B", "die_at_step = 40")):
            roots[run] = tmp_path / run
            cfg = tmp_path / f"{run}.txt"
            cfg.write_text(jax_cli_tests.TestKillAndResume.CFG.format(
                datadir=datadir, rootdir=roots[run], extra=extra))
            r = self._launch(cfg)
            if run == "A":
                assert r.returncode == 0, r.stderr[-2000:]
                continue
            assert r.returncode == -9, (r.returncode, r.stderr[-2000:])
            assert b"[FAULT-INJECTION] SIGKILL at step 40" in r.stdout
            ckpt = os.path.join(roots[run], "kr", "logs", "latest.npz")
            assert read_checkpoint(ckpt)[0] == 40
            r = self._launch(cfg)
            assert r.returncode == 0, r.stderr[-2000:]
            assert b"Reloading from" in r.stdout

        ma, mb = self._metrics(roots["A"]), self._metrics(roots["B"])
        assert set(ma) == set(mb) == {10, 20, 30, 40, 50, 60}
        for step in sorted(ma):
            for field in ("loss", "psnr", "img_loss", "img_loss0",
                          "offsets_loss"):
                assert ma[step][field] == mb[step][field], (step, field)

        cfg = t_config.model_config_from_args(t_config.load_args(
            str(tmp_path / "A.txt")))
        states = [load_train_state(os.path.join(roots[run], "kr", "logs",
                                                "latest.npz"), cfg,
                                   device="cpu")[0] for run in "AB"]
        assert states[0].step == states[1].step == 60
        a, b = states
        for (name, p), q in zip(a.model.named_parameters(),
                                b.model.parameters()):
            assert torch.equal(p, q), name
            assert torch.equal(a.mu[name], b.mu[name]), name
            assert torch.equal(a.nu[name], b.nu[name]), name
