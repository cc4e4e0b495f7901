"""Command-line entry point of the port: not ported yet.

The JAX package's CLI (simplepanorama_tpu/cli.py) is ROADMAP port queue
item 5; until it lands, running this module raises NotImplementedError
naming that item.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from simplepanorama_tpu_torch.stitcher import _not_ported


def main(argv: Optional[Sequence[str]] = None) -> int:
    raise _not_ported("the command-line interface", "CLI and viewer")


if __name__ == "__main__":
    sys.exit(main())
