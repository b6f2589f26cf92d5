import sys
import time

T_START = time.perf_counter()

from stbench.run import main  # noqa: E402  (the start time comes first)

sys.exit(main(t_start=T_START))
