"""A rank of the ``classify_dp4`` cell other than rank 0, which starts it:

    python classify_dp4_rank.py <spec.json>

with a launcher's environment. It runs ``classify_dp4.serve`` of the
operation file beside it and exits with its code.
"""

import json
import os
import sys


def main(path):
    with open(path) as fh:
        spec = json.load(fh)
    sys.path.insert(0, spec["root"])
    from benchmark.lib.spec import load_module

    op = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "classify_dp4.py"), "bench_op_rank")
    return op.serve(spec)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
