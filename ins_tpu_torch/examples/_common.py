"""The examples' shared command line."""

import argparse


def example_main(run):
    """Parse ``--quick`` and ``--device``, call ``run`` and print the
    numbers it returns (and its ``seconds`` per stage)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true", help="tiny grid / few steps")
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    args = parser.parse_args()
    out = run(quick=args.quick, device=args.device)
    out = out or {}
    print("done:", {k: v for k, v in out.items() if isinstance(v, (int, float))},
          out.get("seconds", ""))
    return out
