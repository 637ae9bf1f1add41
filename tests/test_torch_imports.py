"""Guards of the port's rules.

- No file of `nonrigid_nerf_torch/`, nor `chip_smoke.py`, nor the GPU tests
  (which run where JAX is not installed), imports `jax`,
  `nonrigid_nerf_tpu`, `llff_preprocessing` or `tools` (the JAX package is
  the reference, not a dependency; the port keeps its own copies).
- Entry points default to CUDA: with no device argument they ask for
  `cuda`, and on a box without a GPU they raise instead of running on the
  CPU.
- Nothing imports `triton` or builds a kernel at import time.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from nonrigid_nerf_torch import config as t_config
from nonrigid_nerf_torch.apps.render_path import render_path
from nonrigid_nerf_torch.checkpoints import load_train_state
from nonrigid_nerf_torch.device import resolve_device
from nonrigid_nerf_torch.engine.render import make_ray_renderer
from nonrigid_nerf_torch.engine.train_state import create_train_state
from nonrigid_nerf_torch.models.model import NRNeRF
from nonrigid_nerf_torch.weights import params_from_jax

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE_FILES = sorted((REPO / "nonrigid_nerf_torch").rglob("*.py"))
PORT_FILES = PACKAGE_FILES + [REPO / "chip_smoke.py", REPO / "chip_quality.py",
                              REPO / "chip_parallel.py", REPO / "chip_probes.py",
                              REPO / "tests" / "test_torch_kernels_cuda.py",
                              REPO / "tests" / "torch_ranks.py"]
# the files this round of the port added: a rename or a removal must be
# deliberate, and each must stand under the import rule
TRAINING_FILES = ["apps/train.py", "checkpoints.py", "data/__init__.py",
                  "data/dataset.py", "engine/losses.py",
                  "engine/train_state.py", "engine/train_step.py",
                  "ops/kernels/mlp_bwd.py"]
VIEWDIRS_FILES = ["ops/kernels/mlpv_fwd.py", "ops/kernels/mlpv_bwd.py"]
OPT_IN_FILES = ["ops/kernels/mlpe_fwd.py", "ops/kernels/mlpe_bwd.py",
                "ops/kernels/quant_mlp.py"]
FUSED_QUERY_FILES = ["ops/kernels/bend_fwd.py", "ops/kernels/bend_bwd.py",
                     "ops/kernels/fused_fwd.py", "ops/kernels/fused_bwd.py",
                     "ops/kernels/fused_query.py"]
KERNEL_SOURCES = ["mlp_fwd.cu", "mlp_bwd.cu", "mlpv_fwd.cu", "mlpv_bwd.cu",
                  "mlpe_fwd.cu", "mlpe_bwd.cu", "mlp_i8.cu", "mlp_tile.cuh",
                  "bend_fwd.cu", "bend_bwd.cu", "fused_fwd.cu", "fused_bwd.cu",
                  "mlp_sm90.cuh"]
# every kernel runs on mlp_sm90.cuh: rows 1-6 and 9-11 their chain, rows 7
# and 8 the deformation field on row 9's bender
SM90_SOURCES = ("mlp_fwd.cu", "mlp_bwd.cu", "mlpv_fwd.cu", "mlpv_bwd.cu",
                "mlpe_fwd.cu", "mlpe_bwd.cu", "mlp_i8.cu", "fused_fwd.cu",
                "fused_bwd.cu", "bend_fwd.cu", "bend_bwd.cu")
# the first design's chain, which no source runs any more (mlp_tile.cuh no
# longer has it)
TILE_CHAIN = ("chain_forward(", "dh_chain(", "mlp_dw_kernel", "mlp_small_kernel")
SM90_FILES = ["ops/kernels/mlp_sm90.py"]
CLI_FILES = ["cli/__init__.py", "cli/train.py", "cli/summarize.py",
             "data/llff.py",
             "utils/__init__.py", "utils/image_io.py", "utils/video.py",
             "utils/viz.py", "utils/volume.py"]
# free-viewpoint rendering, its metrics and the reference interop
FVR_FILES = ["cli/free_viewpoint_rendering.py", "utils/metrics.py",
             "utils/lpips.py", "interop.py"]
# data parallelism over GPUs: the process group, the step and the renderers
PARALLEL_FILES = ["parallel/__init__.py", "parallel/multihost.py",
                  "parallel/mesh.py"]
# the backward in pieces, bf16's product, serving, preprocessing and the
# interop / serving / preprocessing command lines
LATER_FILES = ["ops/kernels/pieces.py", "models/mlp.py", "serving.py",
               "preprocessing/__init__.py", "preprocessing/colmap_model.py",
               "preprocessing/poses.py", "cli/export_serving.py",
               "cli/import_reference_checkpoint.py",
               "cli/export_reference_checkpoint.py", "cli/preprocess.py"]
FORBIDDEN = ("jax", "jaxlib", "nonrigid_nerf_tpu", "llff_preprocessing",
             "tools")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    assert path.exists()
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_training_files_are_under_the_import_rule():
    covered = {str(p.relative_to(REPO / "nonrigid_nerf_torch"))
               for p in PACKAGE_FILES}
    assert set(TRAINING_FILES) <= covered
    assert set(CLI_FILES) <= covered
    assert set(FVR_FILES) <= covered
    assert set(PARALLEL_FILES) <= covered
    assert set(LATER_FILES) <= covered
    assert (REPO / "nonrigid_nerf_torch" / "ops" / "kernels" / "csrc"
            / "mlp_bwd.cu").exists()


def test_viewdirs_files_are_under_the_import_rule():
    covered = {str(p.relative_to(REPO / "nonrigid_nerf_torch"))
               for p in PACKAGE_FILES}
    assert set(VIEWDIRS_FILES) <= covered and set(SM90_FILES) <= covered
    csrc = REPO / "nonrigid_nerf_torch" / "ops" / "kernels" / "csrc"
    assert sorted(p.name for p in csrc.iterdir()) == sorted(KERNEL_SOURCES)
    for name in KERNEL_SOURCES:
        text = (csrc / name).read_text()
        assert "torch/extension.h" not in text       # plain C interfaces
        if name.endswith(".cu"):
            header = "mlp_sm90.cuh" if name in SM90_SOURCES else "mlp_tile.cuh"
            assert f'#include "{header}"' in text and 'extern "C"' in text
        if name in SM90_SOURCES or name == "mlp_tile.cuh":
            assert not any(f in text for f in TILE_CHAIN), name
    # rows 2, 6 and 10 share the chain kernel: one template, three inputs;
    # rows 1, 5 and 9 likewise the forward's; rows 7 and 8 and row 10's
    # pre-pass and bender backward one forward and one backward of the
    # deformation field. No source has a kernel of its own.
    for name, launch, policy in (
            ("mlp_bwd.cu", "launch_single_head_bwd", "EncodingIn<E>"),
            ("mlpe_bwd.cu", "launch_single_head_bwd", "PtsIn"),
            ("fused_bwd.cu", "launch_single_head_bwd", "EncodingIn<EMB, false>"),
            ("fused_bwd.cu", "launch_bend_forward", "<true>"),
            ("fused_bwd.cu", "launch_bend_backward", "bend_weights"),
            ("bend_fwd.cu", "launch_bend_forward", "<false>"),
            ("bend_bwd.cu", "launch_bend_backward", "weights"),
            ("mlp_fwd.cu", "launch_fwd", "EncodingIn<E>"),
            ("mlpe_fwd.cu", "launch_fwd", "PtsFwdIn"),
            ("fused_fwd.cu", "launch_fwd", "FusedFwdIn")):
        text = (csrc / name).read_text()
        assert launch in text and policy in text
        kernels = [line for line in text.splitlines() if "__global__" in line]
        assert kernels == [], name
    # the header's kernels of the deformation field, and no wmma path left
    header = (csrc / "mlp_sm90.cuh").read_text()
    for kernel in ("bend_fwd_sm90_kernel(", "bend_bwd_sm90_kernel(", "mlp_reduce_kernel("):
        assert kernel in header, kernel
    for name in KERNEL_SOURCES:
        text = (csrc / name).read_text()
        assert "wmma" not in text and "<mma.h>" not in text, name


def test_opt_in_mode_files_are_under_the_import_rule():
    """The modules of fused_kernel="pts" and "int8": present, under the
    import rule, and none reaches for a library's product in place of its
    kernel."""
    covered = {str(p.relative_to(REPO / "nonrigid_nerf_torch"))
               for p in PACKAGE_FILES}
    assert set(OPT_IN_FILES) <= covered
    for name in OPT_IN_FILES:
        text = (REPO / "nonrigid_nerf_torch" / name).read_text()
        assert "_int_mm" not in text and "torch.compile" not in text
        assert "load_kernel_library" in text


def test_fused_query_files_are_under_the_import_rule():
    """The modules of the fused point query: present, under the import rule,
    each kernel module bound to its own CUDA source; the split's kernels,
    row 9 (`FusedFwdIn`) and row 10's pre-pass and bender backward share the
    bender's device code on mlp_sm90.cuh (`bender_rows`); none reaches for a
    library's product in place of its kernel."""
    covered = {str(p.relative_to(REPO / "nonrigid_nerf_torch"))
               for p in PACKAGE_FILES}
    assert set(FUSED_QUERY_FILES) <= covered
    csrc = REPO / "nonrigid_nerf_torch" / "ops" / "kernels" / "csrc"
    for name in FUSED_QUERY_FILES[:4]:
        text = (REPO / "nonrigid_nerf_torch" / name).read_text()
        source = pathlib.Path(name).stem + ".cu"
        assert f'load_kernel_library("{source}")' in text
        assert "torch.compile" not in text and "import triton" not in text
        assert '#include "mlp_sm90.cuh"' in (csrc / source).read_text()
    header = (csrc / "mlp_sm90.cuh").read_text()
    # rows 7, 8 and 9 each call the one bender
    assert header.count("bender_rows<BendLayout<") == 3


def test_library_name_follows_the_source_and_the_shared_header(monkeypatch,
                                                               tmp_path):
    """An edit of a kernel's source or of the header they share gives the
    built library another name, so it is built again."""
    import shutil

    from nonrigid_nerf_torch.ops.kernels import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    before = {s: build._library_path(s) for s in KERNEL_SOURCES[:4]}
    assert len(set(before.values())) == 4
    assert all(p.startswith(build.BUILD_DIR) for p in before.values())
    with open(csrc / "mlpv_fwd.cu", "a") as f:
        f.write("// edited\n")
    assert build._library_path("mlpv_fwd.cu") != before["mlpv_fwd.cu"]
    assert build._library_path("mlp_fwd.cu") == before["mlp_fwd.cu"]
    with open(csrc / "mlp_tile.cuh", "a") as f:
        f.write("// edited\n")
    assert all(build._library_path(s) != before[s] for s in before)


def test_package_imports_without_jax_or_kernels():
    """Importing every module of the port loads neither JAX nor triton, and
    builds nothing."""
    mods = sorted("nonrigid_nerf_torch." + ".".join(
        p.relative_to(REPO / "nonrigid_nerf_torch").with_suffix("").parts)
        for p in PACKAGE_FILES if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'nonrigid_nerf_tpu', 'triton')]\n"
            "assert not bad, bad\n"
            "from nonrigid_nerf_torch.ops.kernels import build\n"
            "assert not build.BUILD_INFO\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_config.ModelConfig(netwidth=32, N_importance=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_ray_renderer(cfg, t_config.RenderSettings())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NRNeRF(cfg, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"latents": np.zeros((1, 32))}, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render_path(None, cfg, t_config.RenderSettings(), [], [],
                    np.zeros((0, 32)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(cfg, t_config.TrainConfig(), 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_train_state("missing.npz", cfg)


def test_training_cli_raises_without_gpu(monkeypatch, tmp_path):
    """`python3 -m nonrigid_nerf_torch.cli.train` without `--device` asks
    for cuda: on a box without a GPU it raises before it writes anything."""
    from nonrigid_nerf_torch.cli import train as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--datadir", str(tmp_path / "data"), "--rootdir",
            str(tmp_path / "exp"), "--expname", "x"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main_function(cli.parse_args(argv))
    assert not (tmp_path / "exp").exists()
    proc = subprocess.run(
        [sys.executable, "-m", "nonrigid_nerf_torch.cli.train"] + argv,
        cwd=REPO, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                       "HOME": str(tmp_path)},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
    assert not (tmp_path / "exp").exists()


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """chip_smoke.py prints no result and exits non-zero without a GPU, and
    also when it stands alone in a directory without the package."""
    script = REPO / "chip_smoke.py"
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(script.read_text())
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
           "HOME": str(tmp_path)}
    for path, cwd in ((script, REPO), (alone, tmp_path)):
        proc = subprocess.run([sys.executable, str(path)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_fvr_cli_raises_without_gpu(tmp_path):
    """`python3 -m nonrigid_nerf_torch.cli.free_viewpoint_rendering` without
    `--device` asks for cuda: on a box without a GPU it raises before it
    writes anything."""
    exp = tmp_path / "exp"
    (exp / "logs").mkdir(parents=True)
    proc = subprocess.run(
        [sys.executable, "-m", "nonrigid_nerf_torch.cli.free_viewpoint_rendering",
         "--input", str(exp), "--deformations", "train", "--camera_path",
         "fixed"],
        cwd=REPO, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                       "HOME": str(tmp_path)},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
    assert sorted(p.name for p in exp.iterdir()) == ["logs"]
