"""Prebuild the native decoder and bind its entries:

    python -m tensorflow_web_deploy_tpu_torch.native.build

Exits 0 when the library is built and every entry the serving paths call
is bound (a library that lacks one raises while it loads); 1 when the
machine lacks a C compiler or libjpeg (the reason is printed; the server
then decodes with PIL). A build that fails for another reason raises.
"""

from __future__ import annotations

import json
import sys

from . import ENTRIES, status


def main() -> int:
    st = status()
    if not st["available"]:
        print(f"native decoder: unavailable ({st['reason']})")
        return 1
    print(f"native decoder: OK, {len(ENTRIES)} entries bound {json.dumps(st)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
