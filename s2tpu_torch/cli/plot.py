"""Interactive segment viewer CLI (the port of ``s2tpu/cli/plot.py``; parity: reference plotting.py:127-179).

    python -m s2tpu_torch.cli.plot <aoi> <label_map> [--data-dir DIR]

Needs matplotlib; no card is used.
"""

from __future__ import annotations

import argparse

from s2tpu_torch.configs.data_config import AOIs, LABEL_MAPS
from s2tpu_torch.plotting import interactive_viewer


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("aoi", choices=list(AOIs))
    p.add_argument("labels", choices=list(LABEL_MAPS))
    p.add_argument("--data-dir", default=None)
    args = p.parse_args(argv)
    interactive_viewer(args.aoi, args.labels, data_dir=args.data_dir)


if __name__ == "__main__":
    main()
