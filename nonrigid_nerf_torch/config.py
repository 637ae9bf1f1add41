"""Configuration of the port: the JAX package's dataclasses and config parser.

An own copy of `nonrigid_nerf_tpu/config.py` (names, fields, keys and
defaults unchanged, `Args`, `resolve_seed` and `default_config_path`
included), so that the port imports nothing of the JAX package and a config
file or `args.txt` means the same to both:

- ModelConfig:    network architecture + encoding (fixed for an experiment)
- RenderSettings: sampling/compositing knobs that differ train vs. test
- EditConfig:     test-time scene-editing controls
- TrainConfig:    optimization settings

`fused_kernel` keeps its modes. "auto" runs the canonical MLP as the CUDA
kernels (with `use_viewdirs` the view-direction pair) whenever the render
device is a GPU and the architecture and edits allow it, "on" forces it (the
plain version on a CPU tensor), "off" runs the plain f32 MLP. Two opt-in
modes: "pts" is "on" with the Fourier encoding computed inside the kernel
(single-head MLP only; rendering and training), and "int8" runs the int8
inference kernel on a model calibrated by
`ops/kernels/quant_mlp.py:quantize_for_inference` (rendering only).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the canonical NeRF + ray-bending networks
    (reference flags: train.py:1003-1219)."""

    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    skips: Tuple[int, ...] = (4,)

    i_embed: int = 0            # 0 = fourier encoding, -1 = identity
    multires: int = 10
    multires_views: int = 4

    use_viewdirs: bool = False
    approx_nonrigid_viewdirs: bool = True

    ray_bending: Optional[str] = "simple_neural"   # None | "simple_neural"
    ray_bending_latent_size: int = 32
    bending_depth: int = 5
    bending_width: int = 64
    bending_activation: str = "relu"               # "relu" | "sin"
    use_rigidity_network: bool = True
    rigidity_depth: int = 3
    rigidity_width: int = 32

    time_conditioned_baseline: bool = False

    N_samples: int = 64
    N_importance: int = 64

    compute_dtype: str = "float32"
    fused_kernel: str = "auto"
    stage1_reuse: bool = True

    def __post_init__(self):
        if self.ray_bending in ("None", "none", ""):
            object.__setattr__(self, "ray_bending", None)
        if self.time_conditioned_baseline and self.ray_bending is not None:
            raise ValueError("time_conditioned_baseline requires ray_bending=None "
                             "(reference: train.py:575-578)")

    @property
    def use_ray_bending(self) -> bool:
        return self.ray_bending is not None

    @property
    def input_ch(self) -> int:
        """Channels of the positionally-encoded 3D point."""
        if self.i_embed == -1:
            return 3
        return 3 + 3 * 2 * self.multires

    @property
    def input_ch_views(self) -> int:
        """Channels of the encoded view direction (0 without view
        directions)."""
        if not self.use_viewdirs:
            return 0
        if self.i_embed == -1:
            return 3
        return 3 + 3 * 2 * self.multires_views

    @property
    def output_ch(self) -> int:
        # vestigial 5th channel kept for weight-shape parity with the
        # reference (train.py:592-593); only 4 are consumed
        return 5 if self.N_importance > 0 else 4


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Per-call rendering knobs (reference: render_kwargs_train/test,
    train.py:698-719)."""

    N_samples: int = 64
    N_importance: int = 64
    perturb: float = 1.0
    raw_noise_std: float = 0.0
    lindisp: bool = False
    white_bkgd: bool = False
    near: float = 0.0
    far: float = 1.0

    def test_mode(self) -> "RenderSettings":
        """No jitter, no density noise (reference: train.py:717-719)."""
        return dataclasses.replace(self, perturb=0.0, raw_noise_std=0.0)


@dataclasses.dataclass(frozen=True)
class EditConfig:
    """Test-time scene editing (reference: free_viewpoint_rendering.py:264-323,
    run_nerf_helpers.py:563-576,309-311)."""

    rigidity_test_time_cutoff: Optional[float] = None
    test_time_scaling: Optional[float] = None
    nonrigid_object_removal_threshold: Optional[float] = None
    render_canonical: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization settings (reference: train.py:1016-1060,1631-1643)."""

    lrate: float = 5e-4
    lrate_decay: int = 250000
    N_iters: int = 200000
    N_rand: int = 1024
    warmup_steps: int = 1000
    offsets_loss_weight: float = 0.0
    divergence_loss_weight: float = 0.0
    rigidity_loss_weight: float = 0.0
    seed: int = 0


# ---------------------------------------------------------------------------
# File-based experiment config: the reference's "key = value" files.
# ---------------------------------------------------------------------------

_BOOL_KEYS = {
    "no_reload", "render_test", "spherify", "debug", "use_viewdirs",
    "approx_nonrigid_viewdirs", "time_conditioned_baseline",
    "use_rigidity_network", "metrics_file",
}
_INT_KEYS = {
    "netdepth", "netwidth", "netdepth_fine", "netwidth_fine", "N_iters",
    "N_rand", "chunk", "netchunk", "seed", "ray_bending_latent_size",
    "train_block_size", "test_block_size", "N_samples", "N_importance",
    "i_embed", "multires", "multires_views", "render_factor",
    "precrop_iters", "factor", "i_print", "i_img", "i_weights", "i_testset",
    "i_video", "lrate_decay", "profile_steps", "die_at_step",
    "bending_depth", "bending_width", "rigidity_depth", "rigidity_width",
    "sampling_prefetch",
}
_FLOAT_KEYS = {
    "lrate", "perturb", "offsets_loss_weight", "divergence_loss_weight",
    "rigidity_loss_weight", "raw_noise_std", "precrop_frac",
}

DEFAULTS = {
    # the reference's config_parser defaults (train.py:983-1219) and the
    # JAX package's own keys, with the same values (its config.py:207-264)
    "config": None,
    "expname": None,
    "datadir": None,
    "rootdir": None,
    "netdepth": 8, "netwidth": 256, "netdepth_fine": 8, "netwidth_fine": 256,
    "N_iters": 200000, "N_rand": 4096, "lrate": 5e-4, "lrate_decay": 250000,
    "chunk": 32768, "netchunk": 65536,
    "no_reload": False, "ft_path": None, "seed": -1,
    "ray_bending": "None", "ray_bending_latent_size": 32,
    "approx_nonrigid_viewdirs": False, "time_conditioned_baseline": False,
    "bending_depth": 5, "bending_width": 64,
    "rigidity_depth": 3, "rigidity_width": 32,
    "use_rigidity_network": True, "bending_activation": "relu",
    "compute_dtype": "float32", "fused_kernel": "auto",
    "train_block_size": 0, "test_block_size": 0,
    "N_samples": 64, "N_importance": 0, "perturb": 1.0,
    "offsets_loss_weight": 0.0, "divergence_loss_weight": 0.0,
    "rigidity_loss_weight": 0.0,
    "use_viewdirs": False, "i_embed": 0, "multires": 10, "multires_views": 4,
    "raw_noise_std": 0.0, "render_factor": 0, "render_test": False,
    "precrop_iters": 0, "precrop_frac": 0.5, "debug": False,
    "dataset_type": "llff", "factor": 8, "spherify": False,
    "bd_factor": "0.75",
    "i_print": 100, "i_img": 500, "i_weights": 1000, "i_testset": 50000,
    "i_video": 50000,
    # a torch.profiler trace of this many steps after the first 50 of a run
    # (logs/profile/), and the metrics stream logs/metrics.jsonl
    "profile_steps": 0,
    "metrics_file": True,
    # fault injection: SIGKILL at the end of this step (after its save), in
    # a fresh run only; 0 = off
    "die_at_step": 0,
    # the JAX package's XLA cache; recorded, without effect here (the
    # kernels' own cache is nonrigid_nerf_torch/_build/)
    "compilation_cache_dir": "~/.cache/nonrigid_nerf_tpu/xla",
    # the JAX package's presampled step; -1, 0 and 1 run the plain step
    "sampling_prefetch": -1,
    # "npz" only ("orbax" raises)
    "checkpoint_format": "npz",
}


def _coerce(key: str, value: str):
    value = value.strip()
    # strip inline comments: "simple_neural # None, simple_neural"
    if "#" in value:
        value = value.split("#", 1)[0].strip()
    if key in _BOOL_KEYS:
        return value.lower() in ("true", "1", "yes")
    if key in _INT_KEYS:
        return int(value)
    if key in _FLOAT_KEYS:
        return float(value)
    if value in ("None", ""):
        return None if key != "ray_bending" else "None"
    return value


def parse_config_file(path: str) -> dict:
    """Parse a reference-style "key = value" config file."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, value = line.split("=", 1)
            key = key.strip()
            out[key] = _coerce(key, value)
    return out


class Args:
    """Attribute-style view over the flat config dict (the reference's
    argparse Namespace), so experiment args.txt files round-trip."""

    def __init__(self, **kwargs):
        merged = dict(DEFAULTS)
        merged.update(kwargs)
        self.__dict__.update(merged)

    def replace(self, **kwargs) -> "Args":
        d = dict(self.__dict__)
        d.update(kwargs)
        return Args(**d)

    def to_dict(self) -> dict:
        return dict(self.__dict__)

    def dump(self, path: str) -> None:
        """Write args.txt in the reference's sorted `key = value` format
        (reference: train.py:1437-1441), re-parseable by load_args."""
        with open(path, "w") as f:
            for key in sorted(self.__dict__):
                f.write("{} = {}\n".format(key, self.__dict__[key]))


def load_args(config_path: Optional[str] = None, **overrides) -> Args:
    values = {}
    if config_path is not None:
        values.update(parse_config_file(config_path))
        values["config"] = config_path
    values.update(overrides)
    return Args(**values)


def model_config_from_args(args: Args) -> ModelConfig:
    return ModelConfig(
        netdepth=args.netdepth, netwidth=args.netwidth,
        netdepth_fine=args.netdepth_fine, netwidth_fine=args.netwidth_fine,
        i_embed=args.i_embed, multires=args.multires,
        multires_views=args.multires_views,
        use_viewdirs=args.use_viewdirs,
        approx_nonrigid_viewdirs=args.approx_nonrigid_viewdirs,
        ray_bending=args.ray_bending,
        ray_bending_latent_size=args.ray_bending_latent_size,
        bending_depth=args.bending_depth, bending_width=args.bending_width,
        bending_activation=args.bending_activation,
        use_rigidity_network=args.use_rigidity_network,
        rigidity_depth=args.rigidity_depth,
        rigidity_width=args.rigidity_width,
        time_conditioned_baseline=args.time_conditioned_baseline,
        N_samples=args.N_samples, N_importance=args.N_importance,
        compute_dtype=args.compute_dtype, fused_kernel=args.fused_kernel,
    )


def resolve_seed(args: Args) -> Args:
    """seed = -1 means unseeded: draw a fresh random seed. The training CLI
    resolves it before it writes args.txt, so the seed that trained is the
    one recorded (reference analog: -1 leaves torch's RNG unseeded,
    train.py:1052)."""
    if args.seed is not None and args.seed >= 0:
        return args
    import secrets
    return args.replace(seed=secrets.randbelow(2 ** 31))


def train_config_from_args(args: Args) -> TrainConfig:
    """seed = -1 draws a fresh seed (`resolve_seed`): resolve `args` first
    where the seed must be recorded."""
    return TrainConfig(
        lrate=args.lrate, lrate_decay=args.lrate_decay, N_iters=args.N_iters,
        N_rand=args.N_rand,
        offsets_loss_weight=args.offsets_loss_weight,
        divergence_loss_weight=args.divergence_loss_weight,
        rigidity_loss_weight=args.rigidity_loss_weight,
        seed=resolve_seed(args).seed,
    )


def render_settings_from_args(args: Args, near: float, far: float) -> RenderSettings:
    return RenderSettings(
        N_samples=args.N_samples, N_importance=args.N_importance,
        perturb=args.perturb, raw_noise_std=args.raw_noise_std,
        lindisp=False, white_bkgd=False, near=float(near), far=float(far),
    )


def default_config_path() -> str:
    """configs/default.txt of the checkout: the training CLI's config file
    when none is given."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "default.txt")
