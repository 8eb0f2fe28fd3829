"""``python -m portbench``: the set-up clock starts before anything heavy is
imported."""
import time

T0 = time.perf_counter()

import sys  # noqa: E402

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
