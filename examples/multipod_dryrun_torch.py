"""Walk one (arch x shape) combination on the reference's production mesh
shape, on ``meta`` tensors, and print its roofline terms at the H100's
constants: the programmatic dry-run API of the PyTorch port.

The counterpart of ``examples/multipod_dryrun.py`` on ``repro_torch``
(``launch/dryrun.lower_one``).  Nothing is allocated and no card is
needed.  A train, prefill or decode step of a config that runs over a
model axis is walked as one rank of a fake process group of the mesh's
size, so ``t_collective`` counts that chip's collectives; elsewhere it is
none.

Run:  PYTHONPATH=src python examples/multipod_dryrun_torch.py \\
          [arch] [shape] [single|multi] [--reduced]
"""

import argparse

from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch.dryrun import lower_one


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="gemma2-2b")
    ap.add_argument("shape", nargs="?", default="decode_32k")
    ap.add_argument("mesh", nargs="?", default="single",
                    choices=("single", "multi"))
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced widths (a quick check)")
    args = ap.parse_args(argv)
    cfg = configs.get_reduced(args.arch) if args.reduced else None
    rec = lower_one(args.arch, INPUT_SHAPES[args.shape],
                    multi_pod=args.mesh == "multi", cfg_override=cfg)
    print("\nroofline terms (seconds/step, H100):")
    for k in ("t_compute", "t_memory", "t_collective"):
        v = rec[k]
        print(f"  {k:13s} " + ("none" if v is None else f"{v:.4f}"))
    print(f"  bottleneck    {rec['bottleneck']}")
    print(f"  useful-FLOPs  {rec['useful_flops_ratio']:.2%}")
    return rec


if __name__ == "__main__":
    main()
