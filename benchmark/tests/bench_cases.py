"""The cells and the cut of a cell that the benchmark's CPU tests run."""

import copy

TRAIN_CELLS = ("nrnerf_flagship.train_r16384", "nrnerf_tc_baseline.train_r16384")
RENDER_CELLS = ("nrnerf_flagship.render_path_384x512",
                "nrnerf_tc_baseline.render_path_384x512")
BIG_SEED = 2 ** 31 + 12345


def tiny(cell: dict, bf16: bool = False) -> dict:
    """A cell cut to a CPU test's size: 4 images of 12 x 16, 8 + 8 samples,
    64 rays a step or a block. By default a 64-wide MLP on the port's f32
    path, held against the reference in f32; with `bf16` the 8 x 256 MLP
    on the kernels' plain versions (their bf16 arithmetic), held against
    the reference in bf16, as on the card."""
    cell = copy.deepcopy(cell)
    cell["config"]["model"].update(N_samples=8, N_importance=8)
    if not bf16:
        cell["config"]["model"].update(netwidth=64, netwidth_fine=64,
                                       fused_kernel="off")
        cell["config"]["precision"]["canonical_mlp"] = "float32"
    else:
        cell["config"]["model"]["fused_kernel"] = "on"
    cell["traffic"]["stack"] = dict(images=4, height=12, width=16, focal=12.0,
                                    near=1.0, far=6.0, z_span=0.5)
    if cell["traffic"]["kind"] == "train":
        cell["traffic"]["N_rand"] = 64
    else:
        cell["traffic"]["chunk"] = 64
    return cell
