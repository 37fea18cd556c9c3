"""``python -m deepflows_tpu_torch.shim SCRIPT [ARGS]``: run a script
written against the reference's ``DeepFlows`` on the port.  The shim's
directory goes first on ``sys.path`` (so ``import DeepFlows`` finds the
port's ``DeepFlows`` package), then the script's own directory, as Python
puts it there; the script runs as ``__main__`` with ``sys.argv`` =
``[SCRIPT, *ARGS]``."""

import os
import runpy
import sys


def main(argv=None) -> int:
    from deepflows_tpu_torch.shim import SHIM_DIR

    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        print("usage: python -m deepflows_tpu_torch.shim SCRIPT [ARGS]", file=sys.stderr)
        return 2
    script = os.path.abspath(argv[0])
    sys.path[:0] = [SHIM_DIR, os.path.dirname(script)]
    sys.argv = [script, *argv[1:]]
    runpy.run_path(script, run_name="__main__")
    return 0


if __name__ == "__main__":
    sys.exit(main())
