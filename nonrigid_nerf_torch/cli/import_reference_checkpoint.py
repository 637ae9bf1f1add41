"""Import a PyTorch-reference experiment (torch.save .tar archives,
reference train.py:1668-1705) as an experiment folder the port resumes
training from or renders (counterpart of
tools/import_reference_checkpoint.py).

    python3 -m nonrigid_nerf_torch.cli.import_reference_checkpoint \\
        REF_EXPDIR_OR_TAR OUT_EXPDIR [--no_optimizer] [--datadir DIR] \\
        [--set key=value ...]

REF_EXPDIR_OR_TAR is either the reference experiment folder (its
logs/args.txt and newest logs/*.tar are used) or a bare .tar path (the
model configuration is then inferred from the state-dict shapes). The Adam
moments convert too, so training continues where the reference left off;
see nonrigid_nerf_torch/interop.py for the contract. Host-only: no device
is touched.
"""

from __future__ import annotations

import argparse
import sys

from nonrigid_nerf_torch.config import _coerce
from nonrigid_nerf_torch.interop import import_reference_experiment


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("src", help="reference experiment dir or .tar path")
    p.add_argument("out", help="output experiment dir (created)")
    p.add_argument("--no_optimizer", action="store_true",
                   help="convert weights only (fresh Adam state on resume)")
    p.add_argument("--datadir", default=None,
                   help="override datadir in the converted args.txt")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="extra args.txt overrides (repeatable)")
    a = p.parse_args(argv)

    overrides = {}
    if a.datadir:
        overrides["datadir"] = a.datadir
    for item in a.set:
        key, sep, value = item.partition("=")
        if not sep:
            p.error(f"--set expects KEY=VALUE, got {item!r}")
        overrides[key.strip()] = _coerce(key.strip(), value)
    summary = import_reference_experiment(
        a.src, a.out, with_optimizer=not a.no_optimizer, overrides=overrides)
    info = summary["info"]
    print(f"imported {summary['source_tar']}")
    print(f"  step {summary['step']}, "
          f"netdepth {info['netdepth']} x netwidth {info['netwidth']}, "
          f"viewdirs={info['use_viewdirs']}, bender={info['has_bender']}, "
          f"{info['n_timesteps']} timesteps x {info['latent_size']} latent")
    print(f"  -> {summary['checkpoint']}")
    print("resume:  python3 -m nonrigid_nerf_torch.cli.train --config "
          f"{a.out}/logs/args.txt")
    print("render:  python3 -m nonrigid_nerf_torch.cli.free_viewpoint_rendering "
          f"--input {a.out} ...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
