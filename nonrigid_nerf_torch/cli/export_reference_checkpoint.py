"""Export an experiment the port trained as a PyTorch-reference checkpoint
tar (the torch.save schema of reference train.py:1668-1705), loadable by
the reference's create_nerf / free_viewpoint_rendering tooling
(counterpart of tools/export_reference_checkpoint.py).

    python3 -m nonrigid_nerf_torch.cli.export_reference_checkpoint \\
        OUR_EXPDIR OUT_TAR [--no_optimizer]

Host-only: no device is touched.
"""

from __future__ import annotations

import argparse
import sys

from nonrigid_nerf_torch.interop import export_experiment


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("exp", help="experiment dir (with logs/latest.npz)")
    p.add_argument("out", help="output .tar path")
    p.add_argument("--no_optimizer", action="store_true",
                   help="export weights only (zero Adam state)")
    a = p.parse_args(argv)
    summary = export_experiment(a.exp, a.out,
                                with_optimizer=not a.no_optimizer)
    print(f"exported step {summary['step']} from {summary['source']}")
    print(f"  -> {summary['tar']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
